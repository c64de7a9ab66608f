"""The port stands alone: importing every module of ``repro_torch`` in a
fresh interpreter pulls in neither JAX nor the JAX package ``repro``.
The machine with the card has no JAX, so a stray import would only show
there; this test catches it on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(",".join(names))
print(",".join(bad))
"""

# modules the walk must reach: one of every layer, the latest slice's too
MUST_IMPORT = {
    "repro_torch.kernels.ref", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.ops", "repro_torch.configs",
    "repro_torch.configs.gemma_2b", "repro_torch.configs.gemma2_9b",
    "repro_torch.launch", "repro_torch.launch.serve",
    "repro_torch.serving.engine", "repro_torch.kvq.attention",
    "repro_torch.obs", "repro_torch.obs.metrics", "repro_torch.obs.trace",
    "repro_torch.obs.costs", "repro_torch.obs.perfmodel",
    "repro_torch.obs.artifacts", "repro_torch.obs.__main__",
    "repro_torch.core.complexity", "repro_torch.dispatch.plan",
    "repro_torch.dispatch.autotune", "repro_torch.dispatch.__main__",
    "repro_torch.calib", "repro_torch.calib.codebook",
    "repro_torch.calib.stats", "repro_torch.calib.fit",
    "repro_torch.calib.quality", "repro_torch.kvq.fit",
    "repro_torch.data.pipeline", "repro_torch.runtime.train",
    "repro_torch.faults", "repro_torch.faults.plan",
    "repro_torch.distributed", "repro_torch.distributed.watchdog",
    "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
    "repro_torch.models.moe", "repro_torch.configs.shapes",
    "repro_torch.configs.codeqwen15_7b", "repro_torch.configs.starcoder2_15b",
    "repro_torch.configs.gpt3_175b", "repro_torch.configs.qwen2_moe",
    "repro_torch.configs.llama4_maverick", "repro_torch.models.mamba",
    "repro_torch.models.xlstm", "repro_torch.configs.jamba_v01",
    "repro_torch.configs.xlstm_1b3", "repro_torch.configs.whisper_medium",
    "repro_torch.configs.phi3_vision", "repro_torch.optim",
    "repro_torch.optim.adamw", "repro_torch.optim.schedules",
    "repro_torch.runtime.driver", "repro_torch.launch.train",
    "repro_torch.distributed.compat", "repro_torch.distributed.sharding",
    "repro_torch.distributed.collectives", "repro_torch.dispatch.shard",
    "repro_torch.launch.mesh", "repro_torch.optim.compression",
    "repro_torch.launch.dryrun",
}
# the port's modules that the reference has no counterpart of
PORT_ONLY = {"__init__.py", "convert.py", "device.py", "kernels/nvcc.py"}


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    names, bad = (res.stdout.splitlines() + [""])[:2]
    names = set(names.split(","))
    assert len(names) >= 30 and MUST_IMPORT <= names, \
        sorted(MUST_IMPORT - names)
    assert bad == "", f"the port imported {bad}"


def test_every_reference_module_has_a_counterpart():
    """The two packages' module files differ only by the port's own
    additions (the reference's package has no top-level __init__)."""
    def modules(pkg):
        root = SRC / pkg
        return {str(p.relative_to(root)) for p in root.rglob("*.py")}

    ref, port = modules("repro"), modules("repro_torch")
    assert ref - port == set(), sorted(ref - port)
    assert port - ref == PORT_ONLY, sorted(port - ref)
