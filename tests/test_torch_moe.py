"""The port's MoE dispatch (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the CPU.

Weights are the reference's ``moe_params(jax.random.key(seed), ...)`` in
float32, carried across as numpy; inputs are the reference's seeded
normals.  Tolerance (float32): |got - want| <= 1e-4 + 1e-4·|want| for
outputs, aux losses and grads.  Expert parallelism runs in gloo ranks
started as ``tests/test_torch_dispatcher.py`` starts them: 2 ranks on a
``("model",)`` mesh, and 8 ranks on a (data 2, model 4) mesh (``slow``,
as the reference's ``test_ep_matches_onehot_multidevice``), each against
the reference's single-device ``onehot``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.testing import given, settings, strategies as st  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from test_torch_dispatcher import run_ranks  # noqa: E402

LEAVES = ("router", "w_gate", "w_up", "w_down")


def f32_close(got, want, what: str) -> None:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - (1e-4 + 1e-4 * np.abs(want))
    assert (excess <= 0).all(), (what, float(excess.max()))


def setup(e=8, k=2, d=32, f=64, b=4, s=24, seed=0):
    """The reference's ``tests/test_moe_dispatch.py`` inputs: (reference
    params, port module, x as numpy)."""
    pj = jmoe.moe_params(jax.random.key(seed), d, f, e, jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.key(seed + 1), (b, s, d),
                                     jnp.float32))
    return pj, port_moe(pj), x


def port_moe(pj) -> moe.MoE:
    e, d, f = pj["w_gate"].shape
    p = moe.MoE(d, f, e, torch.float32)
    p.load_state_dict({k: torch.tensor(np.asarray(pj[k])) for k in LEAVES})
    return p


_J_MOE = jax.jit(jmoe.moe_forward, static_argnames=(
    "top_k", "capacity_factor", "chunk", "dispatch"))


def j_forward(x, pj, **kw):
    y, aux = _J_MOE(jnp.asarray(x), pj, **kw)
    return np.asarray(y), float(aux)


def t_forward(x, p, **kw):
    with torch.no_grad():
        y, aux = moe.moe_forward(torch.tensor(x), p, **kw)
    return y.numpy(), float(aux)


@pytest.mark.parametrize("dispatch", ["gather", "onehot"])
def test_dispatch_matches_the_reference(dispatch):
    pj, p, x = setup()
    kw = dict(top_k=2, chunk=16, dispatch=dispatch)
    y, aux = t_forward(x, p, **kw)
    y_ref, aux_ref = j_forward(x, pj, **kw)
    f32_close(y, y_ref, "y")
    f32_close(aux, aux_ref, "aux")


def test_onehot_matches_gather_values_and_grads():
    """As the reference's ``test_gather_matches_onehot_values_and_grads``,
    and every grad against ``jax.grad`` of the same loss."""
    pj, _, x = setup()
    xt = torch.from_numpy(x)

    def j_loss(params, dispatch):
        y, a = jmoe.moe_forward(jnp.asarray(x), params, top_k=2, chunk=16,
                                dispatch=dispatch)
        return jnp.sum(y ** 2) + a

    grads, outs = {}, {}
    for dispatch in ("onehot", "gather"):
        p = port_moe(pj)
        y, a = moe.moe_forward(xt, p, top_k=2, chunk=16, dispatch=dispatch)
        (torch.sum(y ** 2) + a).backward()
        outs[dispatch] = (y.detach().numpy(), a.item())
        grads[dispatch] = {k: getattr(p, k).grad.numpy() for k in LEAVES}
        want = jax.jit(jax.grad(lambda q: j_loss(q, dispatch)))(pj)
        for k in LEAVES:
            f32_close(grads[dispatch][k], want[k], f"{dispatch} grad {k}")
    np.testing.assert_allclose(outs["onehot"][0], outs["gather"][0],
                               atol=1e-5)
    assert abs(outs["onehot"][1] - outs["gather"][1]) < 1e-6
    for k in LEAVES:
        np.testing.assert_allclose(grads["onehot"][k], grads["gather"][k],
                                   atol=1e-3)


def fifo_drops(gate_idx: np.ndarray, chunk: int, e: int,
               cap: int) -> np.ndarray:
    """Capacity semantics from their definition: within a chunk, a
    (token, slot) pair is kept iff fewer than ``cap`` pairs before it in
    (token, slot) order chose the same expert."""
    kept = np.zeros(gate_idx.shape, bool)
    for c0 in range(0, gate_idx.shape[0], chunk):
        seen = np.zeros(e, np.int64)
        for t in range(c0, c0 + chunk):
            for j, ex in enumerate(gate_idx[t]):
                kept[t, j] = seen[ex] < cap
                seen[ex] += 1
    return kept


def test_capacity_drops_match_the_reference():
    """Tiny capacity (factor 0.3, 4 experts): heavy overflow.  Outputs of
    both engines equal the reference's; the router's choices are
    ``jax.lax.top_k``'s and the drop set is the FIFO definition's."""
    pj, p, x = setup(e=4, k=2)
    kw = dict(top_k=2, chunk=16, capacity_factor=0.3)
    for dispatch in ("gather", "onehot"):
        y, _ = t_forward(x, p, dispatch=dispatch, **kw)
        y_ref, _ = j_forward(x, pj, dispatch=dispatch, **kw)
        f32_close(y, y_ref, dispatch)
    with torch.no_grad():
        gate_idx, kept = moe.routing(torch.from_numpy(x), p, **kw)
    logits = jnp.einsum("td,de->te", jnp.asarray(x.reshape(-1, 32)),
                        pj["router"])
    _, want_idx = jax.lax.top_k(jax.nn.softmax(logits, -1), 2)
    np.testing.assert_array_equal(gate_idx.numpy(), np.asarray(want_idx))
    cap = max(int(16 * 2 / 4 * 0.3), 4)
    want_kept = fifo_drops(np.asarray(want_idx), 16, 4, cap)
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    assert 0 < (~want_kept).sum() < want_kept.size


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.1, 0.25, 0.15],
                      [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    vals, idx = moe.top_k(torch.from_numpy(probs), 3)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def test_pad_tokens_are_routed():
    """26 tokens in chunks of 16: the second chunk's 6 pad rows are routed
    and take capacity, as in the reference."""
    pj, p, x = setup(e=4, k=2, b=1, s=26)
    kw = dict(top_k=2, chunk=16, capacity_factor=0.5)
    with torch.no_grad():
        gate_idx, kept = moe.routing(torch.from_numpy(x), p, **kw)
    assert gate_idx.shape == (32, 2)
    y, aux = t_forward(x, p, dispatch="gather", **kw)
    y_ref, aux_ref = j_forward(x, pj, dispatch="gather", **kw)
    f32_close(y, y_ref, "y")
    f32_close(aux, aux_ref, "aux")


def test_ep_falls_back_to_gather_on_one_rank():
    pj, p, x = setup()
    y1, a1 = t_forward(x, p, top_k=2, chunk=16, dispatch="gather")
    y2, a2 = t_forward(x, p, top_k=2, chunk=16, dispatch="ep")
    np.testing.assert_array_equal(y1, y2)
    assert a1 == a2
    y_ref, a_ref = j_forward(x, pj, top_k=2, chunk=16, dispatch="ep")
    f32_close(y2, y_ref, "y")


@settings(max_examples=10, deadline=None)
@given(st.integers(2, 16), st.integers(1, 4), st.integers(0, 2 ** 30),
       st.floats(0.3, 2.0))
def test_dispatch_engines_agree(e, k, seed, capf):
    """As the reference's ``test_moe_dispatch_engines_agree``: the port's
    gather equals its onehot (the reference's 2e-5), and the reference's
    gather (f32 tolerance)."""
    k = min(k, e)
    d, f = 16, 24
    # seeded numpy weights: ``moe_params`` compiles its draws anew for
    # every expert count
    rng = np.random.default_rng(seed)
    pj = {"router": rng.standard_normal((d, e), np.float32) / 4,
          "w_gate": rng.standard_normal((e, d, f), np.float32) / 4,
          "w_up": rng.standard_normal((e, d, f), np.float32) / 4,
          "w_down": rng.standard_normal((e, f, d), np.float32) / 5}
    x = rng.standard_normal((2, 12, d), np.float32)
    p = port_moe(pj)
    kw = dict(top_k=k, chunk=8, capacity_factor=capf)
    y1, a1 = t_forward(x, p, dispatch="onehot", **kw)
    y2, a2 = t_forward(x, p, dispatch="gather", **kw)
    np.testing.assert_allclose(y1, y2, atol=2e-5)
    assert abs(a1 - a2) < 1e-5
    # eager: every example's shapes would compile anew under jit
    y_ref, a_ref = jmoe.moe_forward(
        jnp.asarray(x), jax.tree.map(jnp.asarray, pj), dispatch="gather",
        **kw)
    f32_close(y2, y_ref, "y")
    f32_close(a2, float(a_ref), "aux")


# -- expert parallelism over gloo ranks ----------------------------------------

_EP_RANK = """
import numpy as np
import torch
from repro_torch.launch.mesh import make_mesh, use_mesh
from repro_torch.models import moe

inp = np.load(f"{tmp}/inp.npz")
names = tuple(str(n) for n in inp["names"])
mesh = make_mesh(tuple(int(n) for n in inp["shape"]), names, device="cpu")
e, d, f = inp["w_gate"].shape
p = moe.MoE(d, f, e, torch.float32)
p.router = torch.nn.Parameter(torch.tensor(inp["router"]))
# this rank's block of the experts
el = e // mesh.size(names.index("model"))
r = mesh.get_local_rank("model")
for k in ("w_gate", "w_up", "w_down"):
    setattr(p, k, torch.nn.Parameter(torch.tensor(inp[k][r * el:][:el])))
x = torch.tensor(inp["x"])
if "data" in names:
    dp = mesh.size(names.index("data"))
    rows = x.shape[0] // dp
    x = x[mesh.get_local_rank("data") * rows:][:rows]
full = moe.MoE(d, f, e, torch.float32)
try:
    with use_mesh(mesh):
        moe.moe_forward(torch.tensor(inp["x"]), full, top_k=2,
                        dispatch="ep")
except ValueError:
    pass              # every expert's weights: not this rank's block
else:
    raise AssertionError("ep took every expert's weights")
calls = []
ep = moe._moe_forward_ep
moe._moe_forward_ep = lambda *a, **kw: calls.append(1) or ep(*a, **kw)
with use_mesh(mesh), torch.no_grad():
    y, aux = moe.moe_forward(x, p, top_k=int(inp["k"]), chunk=16,
                             dispatch="ep")
assert calls == [1], calls
np.savez(f"{tmp}/rank{rank}.npz", y=y.numpy(), aux=aux.numpy())
"""


def run_ep(tmp_path, shape, names):
    """The port's EP on a gloo mesh of ``shape``, every rank's rows against
    the reference's single-device onehot."""
    d, f, e, k = 32, 64, 8, 2
    pj = jmoe.moe_params(jax.random.key(0), d, f, e, jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.key(1), (4, 24, d),
                                     jnp.float32))
    y_ref, a_ref = j_forward(x, pj, top_k=k, chunk=16, dispatch="onehot")
    np.savez(tmp_path / "inp.npz", x=x, k=k, shape=np.asarray(shape),
             names=np.asarray(names),
             **{n: np.asarray(pj[n]) for n in LEAVES})
    world = int(np.prod(shape))
    run_ranks(_EP_RANK, world, tmp_path)
    dp = shape[names.index("data")] if "data" in names else 1
    rows = x.shape[0] // dp
    for r in range(world):
        out = np.load(tmp_path / f"rank{r}.npz")
        di = r // shape[-1] if "data" in names else 0   # model is last
        f32_close(out["y"], y_ref[di * rows:(di + 1) * rows], f"rank {r} y")
        f32_close(out["aux"], a_ref, f"rank {r} aux")


def test_ep_two_ranks_matches_onehot(tmp_path):
    run_ep(tmp_path, (2,), ("model",))


@pytest.mark.slow
def test_ep_matches_onehot_data2_model4(tmp_path):
    run_ep(tmp_path, (2, 4), ("data", "model"))
