"""Fused paged decode attention and on-device sampling."""
