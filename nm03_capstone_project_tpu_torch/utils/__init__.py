"""Host utilities of the drivers: logging, atomic writes, the manifest, timing."""
