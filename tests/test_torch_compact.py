"""Kernel K5's plain versions against the JAX package: ``ops/compact.
compact_reference`` against ``_sort_state_by_active(st, key="active")``
(render/pathtracer.py) with the bounce's uniforms gathered through the
carried index, bit for bit on every field and the permutation, at several
batch sizes and live shares; its autograd route (``CompactFunction``)
against ``jax.vjp`` of the same function; ``unpermute_reference`` against
``.at[idx].set``; the wrappers' refusals; and the bounce loop's calls on the
CPU (one compaction before each bounce after the first, one unpermute).
No octree is needed but for the last test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.render import pathtracer as jpt
from octree_pathtracing_tpu_torch.ops import compact as k5
from octree_pathtracing_tpu_torch.render import pathtracer as tpt

N_BOUNCES = 5
SIZES = (1, 7, 256, 1000)
SHARES = ("none", "all", "0.3", "last")


def _state(b, share, seed):
    """A lane state of ``b`` lanes (numpy), the live lanes chosen by
    ``share``, its carried index a seeded permutation."""
    rng = np.random.default_rng(seed)
    active = {"none": np.zeros(b, bool), "all": np.ones(b, bool), "0.3": rng.random(b) < 0.3,
              "last": np.arange(b) == b - 1}[share]
    return dict(
        origin=rng.normal(size=(b, 3)).astype(np.float32), dir=rng.normal(size=(b, 3)).astype(np.float32),
        throughput=rng.uniform(0.0, 1.0, (b, 3)).astype(np.float32),
        radiance=rng.uniform(0.0, 2.0, (b, 3)).astype(np.float32),
        active=active, specular=rng.random(b) < 0.5, cur_mat=rng.integers(0, 9, b).astype(np.int32),
        idx=rng.permutation(b).astype(np.int32),
    ), rng.random((b, N_BOUNCES, 21), dtype=np.float32)


def _jax_compact(st, uniforms, bounce):
    """JAX's compaction and the bounce's uniforms through the carried index
    (render/pathtracer.py :890-891)."""
    out = jpt._sort_state_by_active({k: jnp.asarray(v) for k, v in st.items()}, key="active")
    return out, jnp.take(jnp.asarray(uniforms)[:, bounce, :], out["idx"], axis=0)


@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("b", SIZES)
def test_compact_reference_matches_jax_bit_for_bit(b, share):
    st_np, u_np = _state(b, share, b)
    bounce = 2
    want, want_u = _jax_compact(st_np, u_np, bounce)
    st = {k: torch.from_numpy(v) for k, v in st_np.items()}
    counts = torch.full((N_BOUNCES,), -1, dtype=torch.int32)
    got, got_u, pos = k5.compact_reference(st, torch.from_numpy(u_np), bounce, counts)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    # the permutation: JAX's over the identity index, and pos its inverse
    perm = np.asarray(_jax_compact(dict(st_np, idx=np.arange(b, dtype=np.int32)), u_np, bounce)[0]["idx"])
    np.testing.assert_array_equal(pos.numpy()[perm], np.arange(b))
    live = int(st_np["active"].sum())
    assert counts.tolist() == [-1, -1, live, -1, -1]
    # no index yet is the identity
    first, _, pos0 = k5.compact_reference(dict(st, idx=None), torch.from_numpy(u_np), bounce)
    np.testing.assert_array_equal(first["idx"].numpy(), perm)
    assert torch.equal(pos0, pos)


@pytest.mark.parametrize("share", ["0.3", "last", "all"])
@pytest.mark.parametrize("b", [7, 256])
def test_compact_gradient_matches_jax_vjp(b, share):
    st_np, u_np = _state(b, share, 10 + b)
    rng = np.random.default_rng(b)
    g_tp, g_rad = (rng.normal(size=(b, 3)).astype(np.float32) for _ in range(2))

    def fn(tp, rad):
        out = jpt._sort_state_by_active(dict({k: jnp.asarray(v) for k, v in st_np.items()}, throughput=tp,
                                             radiance=rad), key="active")
        return out["throughput"], out["radiance"]

    _, vjp = jax.vjp(fn, jnp.asarray(st_np["throughput"]), jnp.asarray(st_np["radiance"]))
    want = vjp((jnp.asarray(g_tp), jnp.asarray(g_rad)))
    st = {k: torch.from_numpy(v) for k, v in st_np.items()}
    tp, rad = (st[k].clone().requires_grad_(True) for k in ("throughput", "radiance"))
    out, _ = k5.compact(dict(st, throughput=tp, radiance=rad), torch.from_numpy(u_np), 1)
    loss = (out["throughput"] * torch.from_numpy(g_tp)).sum() + (out["radiance"] * torch.from_numpy(g_rad)).sum()
    got = torch.autograd.grad(loss, (tp, rad))
    for label, g, w in zip(("throughput", "radiance"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=label)
    # one cotangent alone: the other input takes none
    out, _ = k5.compact(dict(st, throughput=tp, radiance=rad), torch.from_numpy(u_np), 1)
    (d_rad,) = torch.autograd.grad((out["radiance"] * torch.from_numpy(g_rad)).sum(), (rad,))
    np.testing.assert_array_equal(d_rad.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("b", SIZES)
def test_unpermute_reference_matches_jax_set(b):
    rng = np.random.default_rng(b)
    idx = rng.permutation(b).astype(np.int32)
    rad = rng.normal(size=(b, 3)).astype(np.float32)
    want = jnp.zeros((b, 3), jnp.float32).at[jnp.asarray(idx)].set(jnp.asarray(rad))
    got = k5.unpermute_reference(torch.from_numpy(rad), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the wrapper and its gradient: the gather back, d[j] = g[idx[j]]
    x = torch.from_numpy(rad).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(b, 3)).astype(np.float32))
    out = k5.unpermute(x, torch.from_numpy(idx))
    assert torch.equal(out.detach(), got)
    (d,) = torch.autograd.grad((out * g).sum(), (x,))
    np.testing.assert_array_equal(d.numpy(), g.numpy()[idx])


def test_compact_and_unpermute_refuse_what_they_do_not_take():
    st_np, u_np = _state(8, "0.3", 3)
    st = {k: torch.from_numpy(v) for k, v in st_np.items()}
    u = torch.from_numpy(u_np)
    with pytest.raises(ValueError, match="throughput"):
        k5.compact(dict(st, throughput=st["throughput"].double()), u, 1)
    with pytest.raises(ValueError, match="cur_mat"):
        k5.compact(dict(st, cur_mat=st["cur_mat"][:4]), u, 1)
    with pytest.raises(ValueError, match="no specular"):
        k5.compact({k: v for k, v in st.items() if k != "specular"}, u, 1)
    with pytest.raises(ValueError, match="uniforms"):
        k5.compact(st, u[:, :, :20], 1)
    with pytest.raises(ValueError, match="bounce 5"):
        k5.compact(st, u, 5)
    with pytest.raises(ValueError, match="counts"):
        k5.compact(st, u, 1, torch.zeros(5, dtype=torch.int64))
    with pytest.raises(ValueError, match="origin"):
        k5.compact(dict(st, origin=st["origin"].clone().requires_grad_(True)), u, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        k5.compact({k: v.to("meta") for k, v in st.items()}, u.to("meta"), 1)
    with pytest.raises(ValueError, match="idx"):
        k5.unpermute(st["radiance"], st["idx"].long())
    with pytest.raises(ValueError, match="radiance"):
        k5.unpermute(st["radiance"][:, :2], st["idx"])
    before = (k5.compact.launches, k5.compact.backward_launches, k5.unpermute.launches)
    k5.compact(st, u, 1)
    assert (k5.compact.launches, k5.compact.backward_launches, k5.unpermute.launches) == before


def test_the_bounce_loop_compacts_before_each_later_bounce(monkeypatch):
    """``trace_paths`` on the CPU: one compaction before each bounce after
    the first, over the whole batch with the live lanes first; no unpermute
    at the end: the last bounce alone is given the compaction's ``idx``
    and returns the radiance in the lanes' order; every bounce shades all B
    lanes; the census counts agree with the live lanes each compaction
    saw."""
    from octree_pathtracing_tpu_torch.models import minecraft_chunk_scene, pixel_grid_rays

    scene, cam = minecraft_chunk_scene(depth=3)
    o, d = pixel_grid_rays(cam, 8, 8)
    u = torch.from_numpy(np.random.default_rng(5).random((64, N_BOUNCES, 21), dtype=np.float32))
    seen, shaded, unpermuted, given = [], [], [], []
    real_compact, real_shade, real_unpermute = tpt.compact_for_bounce, tpt._shade, k5.unpermute

    def compact(st, uniforms, bounce, counts):
        out = real_compact(st, uniforms, bounce, counts)
        live = int(st["active"].sum())
        seen.append((bounce, live, bool(out[0]["active"][:live].all()), bool((~out[0]["active"][live:]).all()),
                     out[0]["idx"]))
        return out

    def shade(scene, st, *a):
        shaded.append(st["throughput"].shape[0])
        given.append(a[4] if len(a) > 4 else None)
        return real_shade(scene, st, *a)

    monkeypatch.setattr(tpt, "compact_for_bounce", compact)
    monkeypatch.setattr(tpt, "_shade", shade)
    monkeypatch.setattr(k5, "unpermute", lambda *a: unpermuted.append(1) or real_unpermute(*a))
    radiance, live = tpt.trace_paths_census(scene, o, d, u)
    assert [s[0] for s in seen] == [1, 2, 3, 4] and all(s[2] and s[3] for s in seen)
    assert live.tolist() == [64] + [s[1] for s in seen]
    assert shaded == [64] * N_BOUNCES and unpermuted == []
    assert all(g is None for g in given[:-1]) and given[-1] is seen[-1][4]  # the last compaction's idx
    monkeypatch.undo()
    assert torch.equal(radiance, tpt.trace_paths(scene, o, d, u))
