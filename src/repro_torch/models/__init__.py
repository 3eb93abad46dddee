"""The dense decoder family, its paged KV cache and parameter packing."""
