"""The port's checkpoints (``repro_torch.ckpt``) and training driver
(``repro_torch.launch.train``) against the reference's on the CPU.

Both packages write one format (``arrays.npz`` + ``manifest.json`` under
``step-%08d``; bf16 as uint16 bits), so a checkpoint of either restores
in the other with the same bits.  Every comparison here is bit for bit.
"""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import get_reduced_config as j_get_reduced  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.ft.failures import (FailureInjector, StepTimer,  # noqa: E402
                                     run_with_retries)
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

CPU = "cpu"
NAMES = ["llama3.2-3b", "qwen3-moe-30b-a3b", "whisper-small",
         "mamba2-370m"]


def reference_state(name: str, dtype=jnp.bfloat16) -> dict:
    """The reference's reduced train state after one Adam step's worth of
    non-zero moments (``m``, ``v`` seeded numpy) and step 7."""
    cfg = j_get_reduced(name)
    state = jax.jit(lambda k: jstep.init_train_state(cfg, k, dtype))(
        jax.random.key(0))
    rng = np.random.default_rng(0)
    fill = lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)  # noqa: E731
    state["opt"]["m"] = jax.tree.map(fill, state["opt"]["m"])
    state["opt"]["v"] = jax.tree.map(fill, state["opt"]["v"])
    state["opt"]["step"] = jnp.int32(7)
    return state


def bits(path: str) -> tuple[dict, dict]:
    """(arrays, manifest) of a checkpoint directory as stored."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(path, "manifest.json")) as f:
        return arrays, json.load(f)


def same_bits(a: dict, b: dict) -> None:
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def port_train_state(name: str, dtype=torch.bfloat16) -> dict:
    """A port train state after two steps (non-zero moments)."""
    cfg = get_reduced_config(name)
    state = tstep.init_train_state(cfg, torch.Generator().manual_seed(3),
                                   dtype)
    dcfg = T.data_config(cfg, T.RunConfig(arch=name, global_batch=2,
                                          seq_len=8))
    fn, _, _ = tstep.build_train_step(cfg, make_test_mesh(device=CPU))
    for s in range(2):
        batch = {k: torch.from_numpy(v).to(
            dtype if v.dtype.kind == "f" else torch.int32)
            for k, v in make_batch(dcfg, s).items()}
        state, _ = fn(state, batch)
    return state


@pytest.mark.parametrize("name", NAMES)
def test_reference_checkpoint_restores_in_the_port(name, tmp_path):
    jstate = reference_state(name)
    path = jckpt.save(str(tmp_path), 7, jstate, extra={"who": "reference"})
    want, jmanifest = bits(path)
    cfg = get_reduced_config(name)
    like = tstep.abstract_train_state(cfg)
    sh = tstep.state_shardings(like, make_test_mesh(device=CPU))
    state, manifest = ckpt.restore(str(tmp_path), 7, like, sh)
    assert manifest == jmanifest and manifest["extra"] == {"who": "reference"}
    params = state["params"]
    assert all(p.device.type == CPU and p.requires_grad
               for p in params.parameters())
    assert state["opt"]["step"].dtype == torch.int32
    assert int(state["opt"]["step"]) == 7
    # the port's snapshot of what it restored is the reference's file
    arrays, dtypes = ckpt.snapshot(state)
    same_bits(arrays, want)
    assert dtypes == jmanifest["dtypes"]
    # and the model runs
    batch = {"labels": torch.zeros((1, 4), dtype=torch.int32),
             "tokens": torch.zeros((1, 4), dtype=torch.int32)}
    if cfg.frontend == "audio_stub":
        batch["frames"] = torch.zeros((1, 4, cfg.d_model),
                                      dtype=torch.bfloat16)
    from repro_torch.models.transformer import loss_fn
    loss, _ = loss_fn(params, cfg, batch)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("name", NAMES)
def test_port_checkpoint_restores_in_the_reference(name, tmp_path):
    state = port_train_state(name)
    path = ckpt.save(str(tmp_path), 2, state)
    stored, manifest = bits(path)
    cfg = j_get_reduced(name)
    like = jstep.abstract_train_state(cfg)
    tree, jmanifest = jckpt.restore(str(tmp_path), 2, like)
    assert jmanifest == manifest
    keys, leaves, _ = jckpt._paths(tree)
    assert sorted(keys) == sorted(stored)
    for k, leaf in zip(keys, leaves):
        leaf = np.asarray(leaf)
        assert str(leaf.dtype) == manifest["dtypes"][k], k
        assert leaf.shape == stored[k].shape, k
        assert np.array_equal(jckpt._encode(leaf), stored[k]), k
    assert "params/segments/[0]/ln1" in keys and "opt/step" in keys
    # the port reads its own checkpoint back with the same bits
    back, _ = ckpt.restore(str(tmp_path), 2,
                           tstep.abstract_train_state(get_reduced_config(
                               name)))
    same_bits(ckpt.snapshot(back)[0], stored)


def test_run_with_retries_replays_from_checkpoint(tmp_path):
    """The reference's ``test_ft.py`` case on the port's ``ckpt``: every
    failure restores the latest checkpoint and replays to an exact final
    state."""
    ckpt_dir = str(tmp_path / "ckpt")
    state = {"x": np.zeros(4, np.int64)}
    executed = []

    def step_fn(step):
        state["x"] = state["x"] + step
        ckpt.save(ckpt_dir, step, {"x": state["x"]})
        executed.append(step)

    def restore_fn():
        s = ckpt.latest_step(ckpt_dir)
        if s is None:
            state["x"] = np.zeros(4, np.int64)
            return 0
        tree, manifest = ckpt.restore(ckpt_dir, s, {"x": state["x"]})
        assert manifest["step"] == s
        state["x"] = np.asarray(tree["x"])
        return s + 1

    timer = StepTimer()
    inj = FailureInjector(fail_at=(0, 3, 5))
    done, restarts = run_with_retries(step_fn, restore_fn, num_steps=8,
                                      injector=inj, timer=timer)
    assert done == 8 and restarts == 3
    np.testing.assert_array_equal(state["x"],
                                  np.full(4, sum(range(8)), np.int64))
    assert len(timer.durations) == len(executed) == 8
    # the reference reads the port's checkpoints of this loop alike
    tree, _ = jckpt.restore(ckpt_dir, 7, {"x": state["x"]})
    np.testing.assert_array_equal(tree["x"], state["x"])

    def perma_broken(step):
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError):
        run_with_retries(perma_broken, lambda: 0, num_steps=1,
                         max_retries=2)


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """``save`` copies the state to the host before it returns: an
    in-place update right after it is not in the checkpoint."""
    state = port_train_state("llama3.2-3b", torch.float32)
    want = {k: v.copy() for k, v in ckpt.snapshot(state)[0].items()}
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(2, state)
    with torch.no_grad():
        for p in state["params"].parameters():
            p.add_(1.0)
        state["opt"]["step"].add_(1)
    saver.wait()
    stored, _ = bits(os.path.join(str(tmp_path), "step-00000002"))
    same_bits(stored, want)
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_latest_step_and_overwrite(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    os.makedirs(tmp_path / ".tmp-9")          # a crashed save is ignored
    for step in (3, 12, 5):
        ckpt.save(str(tmp_path), step, {"a": np.full(2, step)})
    assert ckpt.latest_step(str(tmp_path)) == 12
    ckpt.save(str(tmp_path), 12, {"a": np.full(2, 99)})
    tree, manifest = ckpt.restore(str(tmp_path), 12, {"a": np.zeros(2)})
    assert manifest["step"] == 12 and tree["a"].tolist() == [99, 99]


def _final_state(run: T.RunConfig) -> tuple[dict, dict]:
    out = T.train(run)
    path = os.path.join(run.ckpt_dir, f"step-{run.steps:08d}")
    return bits(path)[0], out


@pytest.mark.parametrize("fail_at", [(5,), (1,), (3, 8)])
def test_train_replays_to_the_same_state(fail_at, tmp_path):
    """``train`` with injected failures (after a checkpoint, before the
    first one, and twice) ends in the same state, bit for bit, as a run
    without any; the replayed steps log the same losses."""
    common = dict(arch="llama3.2-3b", reduced=True, steps=10,
                  global_batch=2, seq_len=16, microbatches=2,
                  ckpt_every=2, device=CPU)
    clean, out0 = _final_state(T.RunConfig(ckpt_dir=str(tmp_path / "a"),
                                           **common))
    faulty, out1 = _final_state(T.RunConfig(ckpt_dir=str(tmp_path / "b"),
                                            inject_failures=fail_at,
                                            **common))
    same_bits(clean, faulty)
    assert out0["restarts"] == 0 and out1["restarts"] == len(fail_at)
    assert out1["steps"] == out0["steps"] == 10
    first = {r["step"]: r for r in out0["log"]}
    assert len(out1["log"]) > len(out0["log"])
    for r in out1["log"]:
        assert (r["loss"], r["grad_norm"]) == (first[r["step"]]["loss"],
                                               first[r["step"]]["grad_norm"])
    assert set(out1) == {"final_loss", "first_loss", "restarts",
                         "straggler_flags", "steps", "log"}
    assert set(out1["log"][0]) == {"step", "loss", "grad_norm", "sec",
                                   "straggler"}


def test_train_cli_keys_and_device(capsys):
    T.main(["--arch", "llama3.2-3b", "--reduced", "--steps", "2",
            "--global-batch", "2", "--seq-len", "8", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [set(json.loads(x)) for x in lines[:2]] == [
        {"step", "loss", "grad_norm", "sec", "straggler"}] * 2
    assert set(json.loads(lines[-1])) == {"final_loss", "first_loss",
                                          "restarts", "straggler_flags",
                                          "steps"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.main(["--arch", "llama3.2-3b", "--reduced", "--steps", "1"])
