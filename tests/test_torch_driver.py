"""Port parity, the training driver, the device side of the data pipeline,
the train CLI and the train -> quantize -> serve workflow.

* ``runtime.driver.run`` on the reference's TINY config (the twin of
  ``tests/test_substrate.py``'s driver tests), from the reference's
  converted state: the uninterrupted run's losses within rtol 1e-4 of the
  reference driver's; a crash at step 7 and a restart resume at the
  step-5 checkpoint and give the losses of steps 6, 8 and 12 exactly (the
  CPU is deterministic and a checkpoint round-trips bit for bit);
  preemption saves and stops;
* ``SyntheticStream.device_batch`` on the CPU equals ``host_batch`` (and
  the reference's ``device_batch``), int32 tokens and f32 frames; with
  image patches its labels carry IGNORE over the patch positions;
  without a GPU the default device raises; ``prefetch`` matches direct
  access; ``lcg_rule`` gives the reference stream's noise-free tokens;
* ``python -m repro_torch.launch.train --smoke --device cpu`` runs, a
  second call resumes from its checkpoint directory, and its losses equal
  ``driver.run`` over ``train_step`` built by hand; ``--mesh 2x2`` is
  refused without the devices it needs, and without ``--device cpu`` and
  a GPU it raises;
* train -> quantize -> serve (the twin of ``tests/test_system.py``'s
  workflow test): the port trains the reference's CFG model 8 steps on
  the lcg stream (the loss falls),
  then msgemm (d=3, scale_block=36) and int4_dequant copies give logits
  within 2e-3 of each other, the msgemm weights take under 0.55x the
  dense bytes, the msgemm logits correlate above 0.95 with the trained
  dense ones, and the continuous engine's greedy tokens equal static
  ``generate``'s.
"""

import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticStream as JStream  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import schedules as j_sched  # noqa: E402
from repro.runtime import train as JRT  # noqa: E402
from repro.runtime.driver import DriverConfig as JDriverConfig  # noqa: E402
from repro.runtime.driver import run as j_run  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.spec import QuantSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import AdamWConfig, schedules  # noqa: E402
from repro_torch.quant import quantize_model, quantized_size_bytes  # noqa
from repro_torch.runtime import serve as TSV  # noqa: E402
from repro_torch.runtime import train as RT  # noqa: E402
from repro_torch.runtime.driver import (CrashInjector,  # noqa: E402
                                        DriverConfig, run)
from repro_torch.serving import Engine, Request  # noqa: E402

TINY = JConfig(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
               d_ff=64, vocab_size=257, max_seq_len=64)
CFG = JConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=211, max_seq_len=128)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def quiet(*args):
    pass


@functools.lru_cache(maxsize=None)
def _ref_init(jcfg):
    jtcfg = JRT.TrainConfig(optimizer=JAdamW(lr=j_sched.constant(1e-3)))
    return jtcfg, jax.tree.map(np.asarray, JRT.init_state(
        jax.random.PRNGKey(0), jcfg, jtcfg))


def _driver_bits(tmp, jcfg=TINY):
    """The port's state from the reference's TINY init, its step, the
    stream and the driver config of ``test_substrate.py``."""
    _, jstate = _ref_init(jcfg)
    cfg = convert.config_from_jax(jcfg)
    state = convert.state_from_jax(jstate, cfg, device="cpu")
    tcfg = RT.TrainConfig(optimizer=AdamWConfig(lr=schedules.constant(1e-3)))
    data = SyntheticStream(DataConfig(vocab_size=jcfg.vocab_size, seq_len=17,
                                      global_batch=4))
    dcfg = DriverConfig(total_steps=12, checkpoint_every=5,
                        checkpoint_dir=str(tmp), log_every=100)
    return state, RT.make_train_step(cfg, tcfg), data, dcfg


def _losses(res):
    return {m["step"]: m["loss"] for m in res["metrics"]}


def test_driver_matches_reference_and_resumes_exactly(tmp_path):
    state, step_fn, data, dcfg = _driver_bits(tmp_path / "ref")
    ref = run(state, step_fn, data, dcfg, device="cpu", log=quiet)
    want = _losses(ref)
    assert sorted(want) == list(range(1, 13)) and not ref["preempted"]
    assert set(ref["metrics"][0]) >= {"loss", "ce", "z_loss", "grad_norm",
                                      "lr", "load_balance", "dropped_frac"}
    # the reference driver on the same init and stream
    jtcfg, jstate = _ref_init(TINY)
    jres = j_run(jax.tree.map(jax.numpy.asarray, jstate),
                 jax.jit(functools.partial(JRT.train_step, cfg=TINY,
                                           tcfg=jtcfg)),
                 JStream(JDataConfig(vocab_size=257, seq_len=17,
                                     global_batch=4)),
                 JDriverConfig(total_steps=12, checkpoint_every=100,
                               checkpoint_dir=str(tmp_path / "jax"),
                               log_every=100), log=quiet)
    for step, loss in _losses(jres).items():
        np.testing.assert_allclose(want[step], loss, **LOSS_TOL)

    state, step_fn, data, dcfg = _driver_bits(tmp_path / "crash")
    crash = CrashInjector(at_step=7)
    with pytest.raises(RuntimeError, match="injected crash"):
        run(state, step_fn, data, dcfg, device="cpu", crash=crash, log=quiet)
    res = run(state, step_fn, data, dcfg, device="cpu", crash=crash,
              log=quiet)
    assert res["resumed_at"] == 5
    got = _losses(res)
    assert sorted(got) == list(range(6, 13))
    for step in (6, 8, 12):
        assert got[step] == want[step], step
    assert int(res["state"]["step"]) == 12
    assert CheckpointManager(str(tmp_path / "crash")).latest_step() == 12


def test_driver_preemption_saves_and_stops(tmp_path):
    state, step_fn, data, dcfg = _driver_bits(tmp_path)
    stop, calls = [False], []

    def log(msg):
        calls.append(msg)
        if any("step" in c for c in calls):
            stop[0] = True  # request preemption after the first log

    res = run(state, step_fn, data, dcfg, device="cpu", stop_flag=stop,
              log=log)
    assert res["preempted"] and len(res["metrics"]) == 1
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1
    # the saved state restores into a fresh one and resumes there
    fresh, *_ = _driver_bits(tmp_path)
    res = run(fresh, step_fn, data, DriverConfig(
        total_steps=2, checkpoint_dir=str(tmp_path), log_every=100),
        device="cpu", log=quiet)
    assert res["resumed_at"] == 1 and int(res["state"]["step"]) == 2


@pytest.mark.parametrize("frontend", ["", "audio_frames", "image_patches"])
def test_device_batch_equals_host_batch(frontend):
    kw = dict(vocab_size=97, seq_len=9, global_batch=2, seed=3,
              frontend=frontend, d_model=16, num_frames=8, num_patches=3)
    s = SyntheticStream(DataConfig(**kw))
    host = s.host_batch(4)
    dev = s.device_batch(4, device="cpu")
    ref = JStream(JDataConfig(**kw)).device_batch(4)
    assert set(dev) == set(host) == set(ref)
    for k, v in host.items():
        got = dev[k]
        assert got.device.type == "cpu"
        assert got.dtype == (torch.int32 if k in ("tokens", "labels")
                             else torch.float32)
        if k == "labels" and frontend == "image_patches":
            assert torch.all(got[:, :3] == RT.IGNORE)
            got = got[:, 3:]
        assert np.array_equal(got.numpy(), v), k
        assert np.array_equal(v, np.asarray(ref[k])), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            s.device_batch(0)


def test_lcg_rule_matches_reference_stream():
    """``lcg_rule(step)`` gives the reference's lcg tokens exactly at
    every position its noise draw left alone (the draw replayed here)."""
    kw = dict(vocab_size=300, seq_len=64, global_batch=4, seed=5)
    rule = SyntheticStream(DataConfig(**kw)).lcg_rule(2)
    ref = JStream(JDataConfig(**kw)).host_batch(2)
    toks = np.concatenate([ref["tokens"], ref["labels"][:, -1:]], axis=1)
    rng = np.random.default_rng(np.random.SeedSequence([5, 2]))
    for hi in (17, 23, 300):  # a, c and x0, drawn as the stream does
        rng.integers(0, hi, size=(4, 1))
    noise = rng.random((4, 64)) < 0.02
    got = rule(np.arange(64)[None, :])
    assert got.shape == (4, 64) and noise.sum() < 16
    assert np.array_equal(got[~noise], toks[~noise])


def test_prefetch_matches_direct():
    s = SyntheticStream(DataConfig(vocab_size=97, seq_len=9, global_batch=2))
    gen = s.prefetch(start_step=3)
    for want_step in (3, 4, 5):
        step, b = next(gen)
        assert step == want_step
        assert np.array_equal(b["tokens"], s.host_batch(step)["tokens"])
    gen.close()


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", "gemma_2b", "--smoke", "--device", "cpu",
            "--seq-len", "16", "--global-batch", "2",
            "--checkpoint-dir", str(tmp_path / "cli"),
            "--checkpoint-every", "2"]
    first = LT.main(argv + ["--steps", "3"])
    assert first["resumed_at"] == 0 and len(first["metrics"]) == 3
    second = LT.main(argv + ["--steps", "5"])
    assert second["resumed_at"] == 3
    assert [m["step"] for m in second["metrics"]] == [4, 5]
    assert "final loss" in capsys.readouterr().out
    # the same run built by hand: driver.run over train_step
    cfg = configs.get_smoke("gemma_2b")
    state = RT.init_state(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    tcfg = RT.TrainConfig(optimizer=AdamWConfig(
        lr=schedules.warmup_cosine(3e-3, 10, 3)))
    data = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=17,
                                      global_batch=2))
    by_hand = run(state, RT.make_train_step(cfg, tcfg), data,
                  DriverConfig(total_steps=3,
                               checkpoint_dir=str(tmp_path / "hand")),
                  device="cpu", log=quiet)
    assert _losses(by_hand) == _losses(first)


def test_train_cli_refuses_mesh_and_a_missing_gpu(tmp_path):
    with pytest.raises(SystemExit):
        LT.parse_args(["--arch", "gemma_2b", "--mesh", "2x2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LT.main(["--arch", "gemma_2b", "--smoke", "--steps", "1",
                     "--checkpoint-dir", str(tmp_path)])


def test_train_quantize_serve_workflow(tmp_path):
    """Dense training, then int4 weights, then msGeMM serving."""
    state, _, data, _ = _driver_bits(tmp_path, jcfg=CFG)
    cfg = convert.config_from_jax(CFG)
    tcfg = RT.TrainConfig(optimizer=AdamWConfig(lr=schedules.constant(1e-2)))
    res = run(state, RT.make_train_step(cfg, tcfg), data,
              DriverConfig(total_steps=8, checkpoint_dir=str(tmp_path)),
              device="cpu", log=quiet)
    losses = [m["loss"] for m in res["metrics"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    dense = res["state"]["params"]
    models = {}
    for mode in ("msgemm", "int4_dequant"):
        spec = QuantSpec(mode=mode, d=3, scale_block=36)
        models[mode] = (quantize_model(copy.deepcopy(dense), spec),
                        cfg.replace(quant=spec))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, CFG.vocab_size, size=(2, 8)).astype(np.int32))
    with torch.no_grad():
        lg = {k: TT.forward(m, c, toks) for k, (m, c) in models.items()}
        lg_dense = TT.forward(dense, cfg, toks)
    # same int4 weights, two algorithms -> near-identical logits
    np.testing.assert_allclose(lg["msgemm"].numpy(),
                               lg["int4_dequant"].numpy(),
                               rtol=2e-3, atol=2e-3)
    assert quantized_size_bytes(models["msgemm"][0]) < \
        0.55 * quantized_size_bytes(dense)
    corr = np.corrcoef(lg_dense.numpy().ravel(),
                       lg["msgemm"].numpy().ravel())[0, 1]
    assert corr > 0.95, corr
    model, mcfg = models["msgemm"]
    prompts = [tuple(int(t) for t in data.host_batch(100 + i)["tokens"][0,
                                                                       :L])
               for i, L in enumerate((5, 9, 3))]
    eng = Engine(model, mcfg, max_slots=2, block_size=4, prefill_chunk=4,
                 max_model_len=32)
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=6)
                   for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        static = TSV.generate(model, mcfg, torch.tensor([p],
                                                        dtype=torch.int32),
                              max_new_tokens=6)
        assert out[i].generated == [int(t) for t in static[0]], i
