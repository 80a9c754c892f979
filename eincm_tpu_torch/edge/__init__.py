"""Host-side edge maps (numpy + scipy): Canny and inverse distance surfaces."""
