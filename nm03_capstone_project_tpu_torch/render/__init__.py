"""Render + export: the device and host renderers and the JPEG writer."""
