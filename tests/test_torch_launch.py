"""Port parity, configs and the serve CLI: the port's gemma configs equal
the reference's field by field; the port's engine serves gemma2-9b's
SMOKE weights (converted from the JAX package) with the JAX engine's
greedy tokens, on prompts longer than SMOKE's 32-token window, at a
full-precision and an int8 KV pool; ``repro_torch.launch.serve.main``
passes its ``--check`` for both ported architectures at msgemm,
int4_dequant and kv8, serves the recurrent jamba-v0.1 and xlstm-1.3b
through ``--engine static`` (the reference's tokens' path; the
continuous engine refuses them, as the reference's does), and refuses
an unknown architecture."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
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
from repro_torch import configs, convert, obs  # noqa: E402
from repro_torch.kvq import KVQuantSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402


@pytest.mark.parametrize("arch", [
    "gemma_2b", "gemma2_9b", "gemma2-9b", "codeqwen15_7b", "codeqwen1.5-7b",
    "starcoder2_15b", "gpt3_175b", "qwen2_moe", "qwen2-moe-a2.7b",
    "llama4_maverick", "jamba_v01", "jamba-v0.1-52b", "xlstm_1b3",
    "xlstm-1.3b", "whisper_medium", "whisper-medium", "phi3_vision",
    "phi-3-vision-4.2b"])
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_smoke"):
        want = convert.config_from_jax(getattr(j_configs, get)(arch))
        assert getattr(configs, get)(arch) == want


def test_unported_arch_refused():
    """Every reference architecture is ported (the registries are equal),
    so only an unknown name is refused; the continuous engine refuses a
    recurrent model (its paged pool holds K/V only) and the enc-dec and
    vision models (plain decoder-only streams only), as the reference's
    does."""
    assert configs.ARCHS == j_configs.ARCHS
    assert configs.ALIASES == j_configs.ALIASES
    with pytest.raises(NotImplementedError, match="ported: "):
        configs.get_config("no-such-model")
    for arch, match in (("jamba_v01", "paged KV cache"),
                        ("whisper_medium", "decoder-only"),
                        ("phi3_vision", "decoder-only")):
        with pytest.raises(NotImplementedError, match=match):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--engine", "continuous"])


@pytest.mark.parametrize("arch,quant", [
    ("jamba_v01", "msgemm"), ("xlstm_1b3", "msgemm"),
    ("xlstm_1b3", "int4_dequant")])
def test_serve_cli_static_recurrent(arch, quant):
    """The serve CLI's static engine on a recurrent SMOKE model: the
    tokens of static ``generate`` on the CLI's own prompts and weights,
    no kernel launched on the CPU, and a MoE model's dropped_frac."""
    from repro_torch.runtime import serve as SV

    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--engine", "static", "--quant", quant, "--batch", "2",
                      "--prompt-len", "6", "--new-tokens", "4"])
    assert out["cfg"].quant.mode == quant
    assert tuple(out["tokens"].shape) == (2, 4)
    ref = SV.generate(out["params"], out["cfg"], out["prompts"],
                      max_new_tokens=4)
    assert torch.equal(out["tokens"], ref)
    assert all(n == 0 for n in out["launches"].values())
    assert (out["dropped_frac"] is not None) == (arch == "jamba_v01")


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
    ["--mesh", "model=2", "--shard-pipeline", "-1"], ["--shard-impl", "ring"],
    ["--force-host-devices", "4"],
], ids=["mesh", "shard-impl", "force-host-devices"])
def test_serve_cli_refuses_unported_flags(flags):
    """The mesh flags are ported and refused where they do not apply:
    ``--mesh`` with a chunk count below 0 (0 tunes the layout), the
    shard and host-device flags without ``--mesh``; each with a message,
    before anything is built (``--mesh`` serves both engines)."""
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu",
                    *flags])
    want = ("--shard-pipeline -1" if flags[0] == "--mesh"
            else "apply only with --mesh")
    assert isinstance(exc.value.code, str) and want in exc.value.code


@pytest.mark.parametrize("flags,env", [
    (["--faults", "step_fail:p=1.0,after=2,max=2;oom:p=0.5,after=1,max=4",
      "--fault-seed", "0"], None),
    ([], "step_fail:p=1.0,after=2,max=2"),
    (["--watchdog", "--max-queue", "64", "--deadline-s", "600",
      "--ttft-deadline-s", "600"], None),
], ids=["faults", "env", "watchdog"])
def test_serve_cli_resilience_flags(flags, env, capsys, monkeypatch):
    """The reference's resilience flags: --faults (or REPRO_FAULTS) arms
    the plan for the run, the retried steps keep --check's parity and are
    printed; --watchdog and the SLO flags change nothing on a clean run.
    The plan is disarmed when main returns."""
    from repro_torch import faults, obs

    if env is not None:
        monkeypatch.setenv("REPRO_FAULTS", env)
        monkeypatch.setenv("REPRO_FAULT_SEED", "0")
    try:
        out = _main("gemma_2b", "--quant", "msgemm", *flags)
    finally:
        faults.disarm()
    assert out["checked"] == 3
    m, text = out["metrics"], capsys.readouterr().out
    assert faults.active() is None
    assert obs.registry().gauge("faults_armed").value == 0
    if flags[:1] == ["--watchdog"]:
        assert m["step_retries"] == m["shed"] == m["cancelled"] == 0
        assert "fault injection armed" not in text
    else:
        assert m["step_retries"] == 2
        assert "fault injection armed" in text
        assert "[serve] resilience: shed=0 cancelled=0 retries=2" in text


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_serve_cli_learned_kv_codebook(bits, capsys):
    """--kv-codebook learned fits the pool's table from the model's K/V at
    kv4 (printed; --check passes on it) and is ignored with the
    reference's note at kv8 and kv16."""
    out = _main("gemma_2b", "--quant", "msgemm", "--kv-bits", str(bits),
                "--kv-codebook", "learned")
    assert out["checked"] == 3
    text = capsys.readouterr().out
    spec = out["kv_spec"]
    if bits == 4:
        assert spec.codebook is not None and spec.codebook[0] == 0.0
        assert "fitted 16-entry KV codebook" in text
        assert " ".join(f"{v:.4f}" for v in spec.codebook) in text
    else:
        assert f"--kv-codebook learned ignored at --kv-bits {bits}" in text
        assert (spec is None) == (bits == 16)
        assert spec is None or spec.codebook is None


def test_serve_cli_refuses_a_backend_that_cannot_run_the_weights():
    # a GeMM backend reaches the linears through ExecPolicy.backend, and
    # linears whose weights it cannot run fall back to auto-selection
    out = _main("gemma_2b", "--quant", "msgemm", "--backend", "int4_cuda")
    assert out["checked"] == 3
    assert {p.backend for p in out["exec_plans"].values()} == {"msgemm_cuda"}
    with pytest.raises(SystemExit, match="kv-bits"):
        serve.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu",
                    "--backend", "paged_attn_cuda"])


def _plan_cli(tmp_path, *extra):
    return _main("gemma_2b", "--quant", "int4_dequant", "--autotune-cache",
                 str(tmp_path / "plans.json"), *extra)


@pytest.mark.parametrize("flags", [
    ["--autotune"], ["--autotune=full"], ["--autotune=model"]],
    ids=["autotune", "autotune-full", "autotune-model"])
def test_serve_cli_autotunes_the_engine_and_the_check(tmp_path, flags):
    """--autotune times the engine's keys at build and serves the winners;
    --check runs the static path under the same policy and cache."""
    from repro_torch.dispatch import autotune as at

    out = _plan_cli(tmp_path, *flags)
    assert out["checked"] == 3
    tuned = [p for p in out["exec_plans"].values() if p.tiles is not None]
    assert tuned and all(p.source == "autotuned" for p in tuned)
    keys = at.PlanCache(tmp_path / "plans.json").timing_keys()
    assert len(keys) > len(tuned)  # the static path's keys tuned too
    assert any("|b1|" in k for k in keys)  # its decode steps
    out = _plan_cli(tmp_path, "--engine", "static", *flags)
    assert tuple(out["tokens"].shape) == (4, 6)


def test_serve_cli_check_regressions_skips_without_calibration(tmp_path,
                                                              capsys):
    obs.registry().reset()
    out = _plan_cli(tmp_path, "--check-regressions", "--calibration",
                    str(tmp_path / "none.json"))
    assert out["regressions"] is None
    assert "skipped" in capsys.readouterr().err
    # the flag turned tracing on for the run, so the kernel series filled
    assert any(r["name"] == "kernel_gemm_s" and r["count"]
               for r in obs.registry().snapshot()["histograms"])
    assert not obs.tracer().enabled


def test_serve_cli_check_regressions_with_its_own_calibration(tmp_path,
                                                              capsys):
    """A run with --autotune --metrics-json, a calibration fitted from its
    plan cache and snapshot (python -m repro_torch.obs --calibrate), then
    --check-regressions --calibration against it: exit 0, a report of
    this run's kernel series."""
    from repro_torch.obs.__main__ import main as obs_main

    cache, snap = tmp_path / "plans.json", tmp_path / "m.json"
    calib = tmp_path / "c.json"
    _plan_cli(tmp_path, "--autotune", "--metrics-json", str(snap),
              "--check-regressions")
    ctx = json.loads(snap.read_text())["context"]
    assert ctx["plan_device"] == "cpu" and ctx["interpret"] is True
    assert obs_main(["--calibrate", "--plan-cache", str(cache),
                     "--metrics", str(snap), "--calibration",
                     str(calib)]) == 0
    out = _plan_cli(tmp_path, "--autotune", "--check-regressions",
                    "--calibration", str(calib))
    report = out["regressions"]
    assert report["ok"] and report["n_samples"] > 0
    assert "verdict: OK" in capsys.readouterr().out


def test_serve_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma_2b", "--smoke"])


def test_train_cli_on_a_mesh_trains_and_resumes(tmp_path, capfd):
    """``--mesh 2x2 --device cpu --force-host-devices 4``: four gloo
    ranks train 3 steps (checkpoints at 2 and 3), a second call resumes
    at 3 and runs step 4; each step's loss within rtol 1e-4 of the same
    run on one device (``--mesh 1x1``)."""
    from repro_torch.launch import train as LT

    base = ["--arch", "gemma_2b", "--smoke", "--device", "cpu",
            "--checkpoint-every", "2", "--seq-len", "16"]
    mesh = base + ["--mesh", "2x2", "--force-host-devices", "4",
                   "--checkpoint-dir", str(tmp_path / "mesh")]
    first = LT.main(mesh + ["--steps", "3"])
    again = LT.main(mesh + ["--steps", "4"])
    one = LT.main(base + ["--steps", "4", "--checkpoint-dir",
                          str(tmp_path / "one")])
    assert (first["resumed_at"], again["resumed_at"]) == (0, 3)
    got = {m["step"]: m["loss"] for m in first["metrics"] + again["metrics"]}
    want = {m["step"]: m["loss"] for m in one["metrics"]}
    assert sorted(got) == sorted(want) == [1, 2, 3, 4]
    for s in want:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-4, err_msg=s)
    out = capfd.readouterr().out
    assert "[train] 4 ranks" in out and "resumed_at=3" in out


@pytest.mark.parametrize("arch", ["qwen2_moe", "jamba_v01"])
def test_train_cli_on_a_mesh_trains_every_family(arch, tmp_path):
    """``--mesh 2x2 --smoke`` on a MoE and a recurrent arch with 2
    microbatches: each step's loss within rtol 1e-4 of the same run on
    one device."""
    from repro_torch.launch import train as LT

    base = ["--arch", arch, "--smoke", "--device", "cpu", "--seq-len", "16",
            "--global-batch", "4", "--microbatches", "2", "--steps", "2"]
    got = LT.main(base + ["--mesh", "2x2", "--force-host-devices", "4",
                          "--checkpoint-dir", str(tmp_path / "mesh")]
                  )["metrics"]
    want = LT.main(base + ["--checkpoint-dir", str(tmp_path / "one")]
                   )["metrics"]
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["load_balance"], w["load_balance"],
                                   rtol=1e-4)


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "2x2", "--device", "cpu", "--force-host-devices", "2"],
     "needs 4 devices but only 2"),
    (["--mesh", "2x2", "--device", "cpu"], "needs 4 devices but only 0"),
    (["--mesh", "2x2", "--force-host-devices", "4"], "--device cpu"),
    (["--mesh", "2by2"], "expected 'DxM'"),
    (["--mesh", "1x2x2x2"], "expected 'DxM'"),
    (["--mesh", "0x2"], "expected 'DxM'"),
], ids=["too-large", "no-host-devices", "host-devices-on-cuda",
        "spelling", "four-axes", "zero"])
def test_train_cli_refuses_bad_meshes(flags, match, capsys, monkeypatch):
    from repro_torch.launch import mesh as MS
    from repro_torch.launch import train as LT

    monkeypatch.delenv(MS.HOST_DEVICES_ENV, raising=False)

    with pytest.raises(SystemExit):
        LT.parse_args(["--arch", "gemma_2b", *flags])
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["jamba_v01", "whisper_medium"])
def test_serve_cli_static_engine_on_a_mesh(arch, capfd):
    """``--engine static --mesh``: static ``generate`` SPMD over two host
    ranks; ``--check`` holds rank 0's tokens to a single-device
    ``generate`` of the same weights (exact)."""
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--engine", "static", "--check", "--new-tokens", "3",
                      "--mesh", "model=2", "--force-host-devices", "2"])
    text = capfd.readouterr().out
    assert "[serve] mesh {'model': 2}: static generate" in text
    assert "single-device parity check: identical" in text
    assert out["checked"] == 4 and len(out["tokens"]) == 4
    assert out["collectives"]["all_reduce"] > 0
