"""The page program: page → views → detector → NMS → crops → embeddings."""
