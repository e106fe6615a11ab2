"""Configs, typed containers, device/precision and conversion helpers."""
