"""Kernel K5's call path (``ops/compact``) on the CPU, with the CUDA
library replaced by a recorder, as test_torch_shade_call.py and
test_torch_nee_call.py do for K4 and the next-event half: one entry-point
call per forward, backward and unpermute, the forward's outputs carved
from one allocation with the throughput and ``pos`` (which autograd nodes
save) apart, no autograd node without a gradient, the plan cached per batch
size, inputs copied only where the kernel cannot read them as they are,
and every refusal naming its input.  The kernels themselves against their
plain versions: test_torch_gpu.py.  No JAX here.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from octree_pathtracing_tpu_torch.ops import compact as k5
from octree_pathtracing_tpu_torch.ops.shading import N_UNIFORMS

N_BOUNCES = 5


class _Recorder:
    """K5's library: records each entry-point call, launches nothing."""

    def __init__(self):
        self.forward, self.backward, self.unpermute_calls = [], [], []

    @staticmethod
    def compact_scratch_words(b):
        return 2 + max(1, -(-b // 256))

    def compact_forward(self, b, slots, n_slots, stream):
        self.forward.append((b, dict(zip(k5.FORWARD_SLOTS, slots)), n_slots, stream))
        return 0

    def compact_backward(self, b, pos, g_tp, g_rad, d_tp, d_rad, stream):
        self.backward.append((b, pos, g_tp, g_rad, d_tp, d_rad, stream))
        return 0

    def unpermute(self, b, idx, x, out, scatter, stream):
        self.unpermute_calls.append((b, idx, x, out, scatter, stream))
        return 0

    @staticmethod
    def compact_error_string(rc):
        return b"recorded"


class _Ops(TorchDispatchMode):
    """The names of the aten ops run inside the mode."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))

    def count(self, *words):
        return sum(any(w in n for w in words) for n in self.names)


@pytest.fixture(scope="module", autouse=True)
def _warm():
    """The dispatch mode's first use (torch imports its machinery then)."""
    with _Ops():
        torch.zeros(1)


@pytest.fixture
def lib(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(k5, "_library", lambda: rec)
    monkeypatch.setattr(k5, "_uses_kernels", lambda x: True)
    monkeypatch.setattr(k5, "on_current_stream", lambda fn, card, *a: fn(*a, "stream"))
    k5._plan.cache_clear()
    yield rec
    k5._plan.cache_clear()  # no plan made with the recorder outlives the test


def _state(b: int, seed: int = 0, with_idx: bool = True):
    """A lane state of ``b`` CPU lanes and the frame's uniform block, seeded."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    st = dict(origin=t(rng.normal(size=(b, 3)).astype(np.float32)), dir=t(rng.normal(size=(b, 3)).astype(np.float32)),
              throughput=t(rng.uniform(0, 1, (b, 3)).astype(np.float32)),
              radiance=t(rng.uniform(0, 1, (b, 3)).astype(np.float32)), active=t(rng.random(b) < 0.3),
              specular=t(rng.random(b) < 0.5), cur_mat=t(rng.integers(0, 9, b).astype(np.int32)),
              idx=t(rng.permutation(b).astype(np.int32)) if with_idx else None)
    return st, t(rng.random((b, N_BOUNCES, N_UNIFORMS), dtype=np.float32))


@pytest.mark.parametrize("grad", [None, "no_grad", "throughput"])
@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("b", [0, 1, 37, 300])
def test_forward_is_one_entry_point_call_on_three_allocations(lib, b, with_counts, grad):
    st, u = _state(b, seed=b)
    if grad == "throughput":
        st["throughput"].requires_grad_(True)
    counts = torch.full((N_BOUNCES,), -1, dtype=torch.int32) if with_counts else None
    k5.compact(st, u, 2, counts)  # the plan and the scratch of this batch size, once
    lib.forward.clear()
    before = k5.compact.launches
    ops = _Ops()
    with (torch.no_grad() if grad == "no_grad" else contextlib.nullcontext()), ops:
        out, u_b = k5.compact(st, u, 2, counts)
    assert len(lib.forward) == 1 and k5.compact.launches == before + 1  # an empty batch still writes its count
    # the carved outputs, the throughput, pos (and counts where none is given)
    assert ops.count("empty") == (3 if with_counts else 4), ops.names
    assert ops.count("zero", "fill", "copy", "clone", "contiguous") == 0, ops.names
    carved = [out[k] for k in k5.STATE_KEYS + ("idx",) if k != "throughput"] + [u_b]
    base = carved[0].untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base for x in carved)  # views of one buffer
    assert out["throughput"].untyped_storage().data_ptr() != base
    assert out["throughput"].untyped_storage().nbytes() == 12 * b  # saved by K4's node: an allocation of its own
    assert all(x.data_ptr() % 16 == 0 for x in carved + [out["throughput"]])  # each part on a 16-byte boundary
    assert [out[k].shape for k in k5.STATE_KEYS + ("idx",)] == [(b, 3)] * 4 + [(b,)] * 4
    assert [out[k].dtype for k in k5.STATE_KEYS + ("idx",)] == [torch.float32] * 4 + [torch.bool] * 2 + [
        torch.int32] * 2
    assert u_b.shape == (b, N_UNIFORMS) and u_b.dtype == torch.float32
    n, slots, n_slots, stream = lib.forward[0]
    assert (n, n_slots, stream) == (b, len(k5.FORWARD_SLOTS), "stream")
    if b:  # (an empty tensor's data_ptr is 0 whatever its storage)
        for k in k5.STATE_KEYS:
            assert slots[k] == st[k].data_ptr(), k  # the inputs as they are
            assert slots[f"out_{k}"] == out[k].data_ptr(), k
        assert slots["idx"] == st["idx"].data_ptr() and slots["out_idx"] == out["idx"].data_ptr()
        assert slots["uniforms"] == u.data_ptr() and slots["out_u"] == u_b.data_ptr()
    plan = k5._plan(b, N_BOUNCES, torch.device("cpu"))  # the cached plan
    assert k5._plan.cache_info().currsize == 1 and slots["scratch"] == plan.scratch_ptr == plan.scratch.data_ptr()
    assert plan.scratch.numel() >= lib.compact_scratch_words(b) and bool((plan.scratch == 0).all())
    assert slots["bounce"] == 2 and (slots["u_lane_stride"] == N_BOUNCES * N_UNIFORMS or not b)
    if with_counts:
        assert slots["counts"] == counts.data_ptr()
    if grad == "throughput":
        assert type(out["throughput"].grad_fn).__name__ == "CompactFunctionBackward"
    else:  # no autograd node
        assert all(v.grad_fn is None and not v.requires_grad for v in out.values())


def test_backward_and_unpermute_are_one_entry_point_call_each(lib):
    st, u = _state(64, seed=3)
    for k in ("throughput", "radiance"):
        st[k].requires_grad_(True)
    out, _ = k5.compact(st, u, 1)
    (out["throughput"].sum() + out["radiance"].sum()).backward()
    assert len(lib.forward) == 1 and len(lib.backward) == 1
    b, pos, g_tp, g_rad, d_tp, d_rad, stream = lib.backward[0]
    assert (b, stream) == (64, "stream") and all(x is not None for x in (pos, g_tp, g_rad, d_tp, d_rad))
    assert d_tp == st["throughput"].grad.data_ptr() and d_rad == st["radiance"].grad.data_ptr()
    # the throughput alone requiring grad: no radiance cotangent asked for
    st2, u2 = _state(64, seed=4)
    st2["throughput"].requires_grad_(True)
    out2, _ = k5.compact(st2, u2, 1)
    out2["throughput"].sum().backward()
    assert len(lib.backward) == 2 and lib.backward[1][5] is None and lib.backward[1][3] is None
    rad = torch.rand((64, 3), requires_grad=True)
    idx = torch.randperm(64).to(torch.int32)
    ops = _Ops()
    with ops:
        back = k5.unpermute(rad, idx)
    assert ops.count("empty") == 1 and ops.count("copy", "clone", "contiguous") == 0, ops.names
    back.sum().backward()
    assert [c[4] for c in lib.unpermute_calls] == [1, 0]  # the scatter, then the gather back
    assert lib.unpermute_calls[0][3] == back.data_ptr() and lib.unpermute_calls[1][3] == rad.grad.data_ptr()


def test_plan_is_cached_per_batch_size_and_renewed_by_a_new_one(lib):
    st, u = _state(100, seed=1)
    cpu = torch.device("cpu")
    k5.compact(st, u, 0)
    k5.compact(st, u, 4)
    info = k5._plan.cache_info()
    assert (info.misses, info.hits, info.currsize) == (1, 1, 1)
    plan = k5._plan(100, N_BOUNCES, cpu)
    st2, u2 = _state(1000, seed=2)
    k5.compact(st2, u2, 0)
    assert k5._plan.cache_info().currsize == 2
    big = k5._plan(1000, N_BOUNCES, cpu)
    assert big is not plan and k5._plan(100, N_BOUNCES, cpu) is plan
    assert big.n_bytes > plan.n_bytes and big.scratch.numel() >= lib.compact_scratch_words(1000)
    _, u3 = _state(100, seed=1)
    k5.compact(st, u3[:, :3].contiguous(), 0)  # a block of three bounces: a plan of its own
    assert k5._plan.cache_info().currsize == 3


@pytest.mark.parametrize("b", [1, 7, 65553])
def test_forward_layout_is_aligned_and_disjoint(lib, b):
    plan = k5._plan(b, N_BOUNCES, torch.device("cpu"))
    item = {0: 4, 1: 4, 2: 1}
    spans = sorted((plan.offsets[k], plan.offsets[k] + int(np.prod(shape)) * item[kind])
                   for k, _, shape, _, kind in plan.parts)
    assert len(spans) == len(k5.STATE_KEYS) + 1  # every output but the throughput, with idx and the uniforms
    assert all(start % 16 == 0 for start, _ in spans) and spans[-1][1] <= plan.n_bytes
    assert all(a[1] <= b_[0] for a, b_ in zip(spans, spans[1:]))


def test_inputs_the_kernel_cannot_read_as_they_are_are_copied(lib):
    st, u = _state(40, seed=5)
    wide = torch.zeros((41, 3))
    wide[1:] = st["origin"]
    st["origin"] = wide[1:]  # dense but 12 bytes past an aligned start
    st["dir"] = torch.cat([st["dir"], st["dir"][:, :1]], 1)[:, :3]  # rows of 4 floats
    u_view = torch.zeros((40, N_BOUNCES, N_UNIFORMS + 1))[..., :N_UNIFORMS]  # a strided row
    u_view.copy_(u)
    out, u_b = k5.compact(st, u_view, 3)
    slots = lib.forward[0][1]
    assert slots["origin"] == st["origin"].data_ptr()  # dense rows are read where they lie, aligned or not
    assert slots["dir"] != st["dir"].data_ptr()  # rows of 4 floats: copied dense
    assert slots["throughput"] == st["throughput"].data_ptr()
    assert slots["uniforms"] != u_view.data_ptr() and slots["u_lane_stride"] == N_BOUNCES * N_UNIFORMS


def test_refusals_name_the_wrong_input(lib):
    st, u = _state(16, seed=6)
    bad = {
        "origin": dict(st, origin=st["origin"].double()),
        "dir": dict(st, dir=st["dir"][:, :2]),
        "throughput": dict(st, throughput=st["throughput"][:8]),
        "radiance": dict(st, radiance=st["radiance"].half()),
        "active": dict(st, active=st["active"].int()),
        "specular": dict(st, specular=st["specular"][:, None]),
        "cur_mat": dict(st, cur_mat=st["cur_mat"].long()),
        "idx": dict(st, idx=st["idx"].long()),
    }
    for name, s in bad.items():
        with pytest.raises(ValueError, match=name):
            k5.compact(s, u, 1)
    with pytest.raises(ValueError, match="has no specular"):
        k5.compact({k: v for k, v in st.items() if k != "specular"}, u, 1)
    with pytest.raises(ValueError, match="uniforms"):
        k5.compact(st, u[:, :, :20], 1)
    with pytest.raises(ValueError, match="bounce 5"):
        k5.compact(st, u, 5)
    with pytest.raises(ValueError, match="counts"):
        k5.compact(st, u, 1, torch.zeros((N_BOUNCES,), dtype=torch.int64))
    with pytest.raises(ValueError, match="counts"):
        k5.compact(st, u, 1, torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\['origin'\]"):
        k5.compact(dict(st, origin=st["origin"].clone().requires_grad_(True)), u, 1)
    with pytest.raises(ValueError, match=r"\['uniforms'\]"):
        k5.compact(st, u.clone().requires_grad_(True), 1)
    with pytest.raises(ValueError, match="idx"):
        k5.unpermute(st["radiance"], st["idx"].long())
    with pytest.raises(ValueError, match="radiance"):
        k5.unpermute(st["radiance"].double(), st["idx"])
    assert lib.forward == [] and lib.unpermute_calls == []
    refused = type("Refused", (_Recorder,), {"compact_forward": lambda self, *a: 1})()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k5, "_library", lambda: refused)
        before = k5.compact.launches
        with pytest.raises(RuntimeError, match="compact_forward launch failed: recorded"):
            k5.compact(st, u, 1)
        assert k5.compact.launches == before


def test_scratch_grows_outside_a_capture_only(lib, monkeypatch):
    monkeypatch.setattr(k5, "_SCRATCH", {})
    dev = torch.device("cpu")
    small = k5._scratch(dev, 16)
    assert k5._scratch(dev, 16) is small and k5._scratch(dev, small.numel()) is small
    big = k5._scratch(dev, small.numel() + 1)
    assert big is not small and big.numel() == small.numel() + 1 and bool((big == 0).all())
    assert k5._SCRATCH[None][-2] is small  # kept: a graph captured with it replays against it
