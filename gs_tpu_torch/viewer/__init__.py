"""Live-viewer bridge: the SIBR remote-viewer TCP protocol."""
