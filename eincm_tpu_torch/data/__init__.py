"""Host-side event data: the synthetic loader, windowing and staging."""
