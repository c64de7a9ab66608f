"""Entry points of the port; port of repro.launch (the serve and train
CLIs, and the device mesh with its rank processes)."""
