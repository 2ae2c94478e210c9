"""Paged-KV decoder serving: the slice-pool allocator as a decoder's KV
store."""
