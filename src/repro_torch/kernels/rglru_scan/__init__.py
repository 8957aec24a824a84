"""RG-LRU linear-recurrence scan (recurrentgemma's hot spot)."""
