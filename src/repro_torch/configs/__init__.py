"""Architecture registry of the port; port of repro.configs.

One module per ported architecture, each exporting ``CONFIG`` (the exact
public config) and ``SMOKE`` (a reduced config of the same family for CPU
tests).  ``get_config(name)`` / ``get_smoke(name)`` take a module name or
one of its public aliases; ``shapes.py`` holds the input-shape cells.
``ARCHS`` is the reference's; any other name raises NotImplementedError.
"""

from __future__ import annotations

import importlib

ARCHS = (
    "llama4_maverick",
    "qwen2_moe",
    "whisper_medium",
    "xlstm_1b3",
    "gemma_2b",
    "codeqwen15_7b",
    "starcoder2_15b",
    "gemma2_9b",
    "jamba_v01",
    "phi3_vision",
    "gpt3_175b",  # the paper's own model (not in the assigned pool)
)

ALIASES = {
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "qwen2-moe-a2.7b": "qwen2_moe",
    "whisper-medium": "whisper_medium",
    "xlstm-1.3b": "xlstm_1b3",
    "gemma-2b": "gemma_2b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "starcoder2-15b": "starcoder2_15b",
    "gemma2-9b": "gemma2_9b",
    "jamba-v0.1-52b": "jamba_v01",
    "phi-3-vision-4.2b": "phi3_vision",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise NotImplementedError(
            f"unknown arch {name!r}; ported: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE
