"""Host-side IO of the port: image discovery and decode, JSON schemas, progress tracking, the prefetcher and logging."""
