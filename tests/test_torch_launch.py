"""Port parity, configs and the serve CLI: the port's gemma configs equal
the reference's field by field; the port's engine serves gemma2-9b's
SMOKE weights (converted from the JAX package) with the JAX engine's
greedy tokens, on prompts longer than SMOKE's 32-token window, at a
full-precision and an int8 KV pool; ``repro_torch.launch.serve.main``
passes its ``--check`` for both ported architectures at msgemm,
int4_dequant and kv8, and refuses what is not ported."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.kvq import KVQuantSpec as JKVSpec  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kvq import KVQuantSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402


@pytest.mark.parametrize("arch", ["gemma_2b", "gemma2_9b", "gemma2-9b"])
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_smoke"):
        want = convert.config_from_jax(getattr(j_configs, get)(arch))
        assert getattr(configs, get)(arch) == want


def test_unported_arch_refused():
    with pytest.raises(NotImplementedError, match="A11"):
        configs.get_config("xlstm_1b3")
    with pytest.raises(NotImplementedError, match="A11"):
        configs.get_smoke("qwen2-moe-a2.7b")
    with pytest.raises(NotImplementedError, match="ported: "):
        configs.get_config("no-such-model")
    with pytest.raises(NotImplementedError):
        serve.main(["--arch", "jamba_v01", "--smoke", "--device", "cpu"])


@pytest.fixture(scope="module")
def gemma2_pair():
    """gemma2-9b SMOKE with msgemm weights in both packages."""
    spec = JSpec(mode="msgemm", d=3, scale_block=36)
    jcfg = j_configs.get_smoke("gemma2_9b")
    jp = j_quantize(JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg, spec)
    jcfg = jcfg.replace(quant=spec)
    tcfg = convert.config_from_jax(jcfg)
    model = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    return jp, jcfg, model, tcfg


def _serve(engine_cls, req_cls, params, cfg, prompts, **kw):
    eng = engine_cls(params, cfg, max_slots=2, block_size=8,
                     prefill_chunk=16, max_model_len=64, **kw)
    res = eng.run([req_cls(rid=i, prompt=p, max_new_tokens=6)
                   for i, p in enumerate(prompts)])
    return [res[i].generated for i in range(len(prompts))]


@pytest.mark.parametrize("kv", [None, 8], ids=["f32-pool", "kv8"])
def test_gemma2_engine_matches_jax_past_the_window(gemma2_pair, kv):
    jp, jcfg, model, tcfg = gemma2_pair
    window = tcfg.sliding_window
    rng = np.random.default_rng(11)
    prompts = [tuple(int(t) for t in rng.integers(0, tcfg.vocab_size,
                                                  size=L))
               for L in (window + 9, window + 20, 5)]
    got = _serve(Engine, Request, model, tcfg, prompts,
                 kv_quant=None if kv is None else KVQuantSpec(kv))
    want = _serve(JEngine, JRequest, jp, jcfg, prompts,
                  kv_quant=None if kv is None else JKVSpec(kv))
    assert got == want


def _main(arch, *extra):
    return serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--engine", "continuous", "--num-requests", "3",
                       "--new-tokens", "6", "--check", *extra])


@pytest.mark.parametrize("arch", ["gemma_2b", "gemma2_9b"])
@pytest.mark.parametrize("extra", [("--quant", "msgemm"),
                                   ("--quant", "int4_dequant"),
                                   ("--quant", "msgemm", "--kv-bits", "8")],
                         ids=["msgemm", "int4", "kv8"])
def test_serve_cli_check_passes(arch, extra):
    out = _main(arch, *extra)
    assert out["checked"] == 3 and out["steps"] > 0
    assert out["cfg"].quant.mode == extra[1]
    assert all(n == 0 for n in out["launches"].values())  # CPU: no kernel
    assert (out["kv_spec"] is not None) == ("--kv-bits" in extra)


def test_serve_cli_forces_the_attention_route():
    first = _main("gemma2_9b", "--quant", "msgemm", "--kv-bits", "8")
    again = _main("gemma2_9b", "--quant", "msgemm", "--kv-bits", "8",
                  "--backend", "paged_attn_torch")
    assert first["kv_spec"].backend is None
    assert again["kv_spec"].backend == "paged_attn_torch"
    for rid, seq in first["results"].items():
        assert again["results"][rid].generated == seq.generated


def test_serve_cli_static_engine():
    out = serve.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu",
                      "--quant", "bf16", "--batch", "2", "--prompt-len", "5",
                      "--new-tokens", "3"])
    assert tuple(out["tokens"].shape) == (2, 3)


@pytest.mark.parametrize("flags", [
    # "metrics": --metrics-json/--trace-out/--prom-port are ported; the
    # perf-model sentinel that reads the kernel metrics is not (A8)
    ["--mesh", "model=2"], ["--autotune"], ["--check-regressions"],
    ["--faults", "all"], ["--watchdog"], ["--calibration", "c.json"],
    ["--kv-bits", "4", "--kv-codebook", "learned"],
], ids=["mesh", "autotune", "metrics", "faults", "watchdog", "calibration",
        "learned-codebook"])
def test_serve_cli_refuses_unported_flags(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu",
                    *flags])
    assert exc.value.code == 2
    if "learned" in flags:
        assert "kvq/fit.py" in capsys.readouterr().err


def test_serve_cli_refuses_a_backend_that_cannot_run_the_weights():
    with pytest.raises(SystemExit, match="cannot run"):
        serve.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu",
                    "--quant", "msgemm", "--backend", "int4_cuda"])
    with pytest.raises(SystemExit, match="kv-bits"):
        serve.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu",
                    "--backend", "paged_attn_cuda"])


def test_serve_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma_2b", "--smoke"])
