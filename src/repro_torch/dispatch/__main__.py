"""``python -m repro_torch.dispatch`` — the autotuner CLI (see autotune.py).

Preferred over ``python -m repro_torch.dispatch.autotune``: running the
submodule as __main__ creates a second copy of its module state next to
the one the package already imported.
"""

from repro_torch.dispatch.autotune import main

if __name__ == "__main__":
    raise SystemExit(main())
