"""Host-side virtualization substrate (the MMU)."""
