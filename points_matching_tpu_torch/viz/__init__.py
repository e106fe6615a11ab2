"""Offline visualization (numpy rasterization, PNG output)."""
