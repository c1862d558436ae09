"""Embedding store: persistent collections with exact cosine top-k on the device."""
