"""Host-side image I/O and synthetic image rendering."""
