"""Entry points of the port; port of repro.launch (the serve CLI)."""
