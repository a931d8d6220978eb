"""Host-side data: RCV1 loading/packing and synthetic RCV1-shaped sets."""
