"""RWKV-6 WKV recurrence (rwkv6-7b's hot spot)."""
