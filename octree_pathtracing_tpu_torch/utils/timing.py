"""Timing on the card: what a caller pays per call, and what the device
spends on it.

- :func:`call_ms`: CUDA events around back-to-back calls.  It includes the
  host path (Python, argument checks, allocation, the launch itself), so it
  is what an eager caller pays whenever that host path is longer than the
  kernel.
- :func:`device_ms`: the same calls captured into one CUDA graph and
  replayed, CUDA events around the replays, divided by the calls: device
  time alone.  A kernel launched through ``ctypes`` on PyTorch's current
  stream captures like any other.  Where capture fails, torch.profiler's
  device time stands in, and the result says so.

Run as a script, it times kernels P1 (row gather) and P2 (Philox uniforms)
of one or more checkouts of the port beside the PyTorch calls that compute
the same functions (``torch.index_select``, ``torch.rand``), and the
traversal kernels at the shapes the main paths give them::

    python3 octree_pathtracing_tpu_torch/utils/timing.py [--out FILE] [--world FILE] \
        [--k4 | --bounces | --k5 | --nee | --train | --prims | --k8] ROOT [ROOT ...]

Each ROOT is a directory holding ``octree_pathtracing_tpu_torch/`` (this
checkout, or an older commit unpacked with ``git archive``); each is timed
in a process of its own, in the order given, so "parent, change, change,
parent" compares two commits on one card.  Shapes: P1 at the probe's
(131072, 8) int32 table with 4096 indices, and at the emitter grid's
(4096, 8) int32 and float32 tables with 65536 random indices; the emitter
pick's two gathers (one pair launch, or two single launches where the
checkout has no pair); P2 on the (65536, 5, 21) uniform block.  The
traversal on the depth-9 scenes: K1 on the terrain's 256x256 primaries and
on bounces 2-5 of one headline frame (``trace_paths``, IMPORTANCE sun, the
uniforms of seed 1: since K5 the whole batch with its active mask, before
it the live rays alone; each row with its lanes and live lanes); K2 on the cutout's 256x256
primaries and its 8 training views at 512x512; K3r on the terrain's
training views; K3s on the cutout's sun walk; K2q in its three modes on the
plant field (primaries; sun and hemisphere walks).  Each traversal row
carries the max, p50 and p99 of its per-ray fetches.  K4's rows time
``_shade`` on each bounce of one headline frame, forward (call and device
ms) and with its backward (call ms), whatever shading the checkout has (its
kernels, or the eager shading before them), and K4's backward call alone
on each bounce (call and device ms, its fills included), on the cotangents
a real fwd+bwd of the frame hands it, where the checkout has the kernels;
the headline frame itself is
timed forward and with bench.py's backward (host ms, median of 5) with the
device activities torch.profiler counts in it; so are the light lines
(the depth-9 terrain under the HIGH_QUALITY sun, with and without
one-emitter NEE; the cutout, the plant field and the analytic scene under
it, and the analytic scene under IMPORTANCE; with ``--world FILE`` a region
read at depth 9 under HIGH_QUALITY with one-emitter NEE), where a checkout
with the next-event kernels also counts the activities through their plain
version.  Every kernel result
is checked bit for bit against its plain-torch twin first.  The next-event
kernels are timed on each bounce of one NEE-line frame (lanes and live
lanes beside each row).  In a checkout with K5 (``ops/compact``): its
forward and backward on the headline frame's compactions and at 2,097,152
lanes beside its plain version and two library routes (``argsort_route``,
``nonzero_route``), the unpermute both ways, and the headline forward frame
captured in a CUDA graph (``capture_frame``; the replays' device ms,
bit-equal to the eager frame; a capture that fails raises).  ``--nee``
times the next-event kernels alone (an A/B of their design): each of
``nee_setup``, ``nee_resolve`` and ``nee_backward`` by call and on the
device on every bounce of one frame of the NEE, cutout, config-3 and, with
``--world``, world lines, then the light lines' frames and the headline's
forward and fwd+bwd with their device activities.  ``--k4``
times K4's rows and the headline frames alone (an A/B of K4's design),
with the primitives' share of the analytic scene's bounces (``_shade``
and ``nee_setup`` with K7 apart or folded in, ``_prim_cases``; ``--prims``
those rows alone);
``--bounces`` the bounce loop's rows alone: K1, K4 and the next-event
kernels per bounce, the headline frames, K5's rows; ``--k5`` K5's rows and
the headline frame's graph replay alone (an A/B of K5's design);
``--train`` chip_smoke.py's phase-7 training commands with their peak
device memory; ``--k8`` kernel K8 on the depth-9 plant field's quad soup
(``_time_k8``).  The depth-9
octrees are cached under ``build/scenes`` of this file's checkout.  Needs
a CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

CALLS = 200  # back-to-back calls per call_ms
GRAPH_CALLS = 100  # calls captured per graph
REPLAYS = 5


def card_line() -> str:
    """``name, power.limit`` of the card in use, as nvidia-smi prints them."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    idx = int(first) if first.isdigit() else 0
    return lines[idx] if idx < len(lines) else lines[0]


def call_ms(fn, repeats: int = CALLS) -> float:
    """Mean ms per call over ``repeats`` back-to-back calls, after one
    warm-up: CUDA events, so the host path counts where it is longer than
    the device work."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def _graph_ms(fn, calls: int, replays: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def _profiler_ms(fn, calls: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / calls


def device_ms(fn, calls: int = GRAPH_CALLS, replays: int = REPLAYS):
    """(ms, how): device ms per call of ``fn``, from ``calls`` calls
    captured into one CUDA graph (how = "graph"); where capture fails, from
    torch.profiler's device time (how = "profiler: <the capture error>")."""
    try:
        return _graph_ms(fn, calls, replays), "graph"
    except Exception as e:  # noqa: BLE001 -- said on the result
        torch.cuda.synchronize()
        return _profiler_ms(fn, calls), f"profiler: capture failed ({type(e).__name__}: {e})"


def both(fn) -> dict:
    """{"call_ms", "device_ms", "device_by"} of ``fn``."""
    dms, how = device_ms(fn)
    return {"call_ms": call_ms(fn), "device_ms": dms, "device_by": how}


def fetch_stats(fetches) -> dict:
    """{"fetch_max", "fetch_p50", "fetch_p99"} of a call's per-ray fetch
    counts over the rays that walked (an inactive lane fetches nothing, an
    active one at least once): whether a call is bound by its longest walk."""
    f = fetches[fetches > 0].float()
    q = torch.quantile(f, torch.tensor([0.5, 0.99], device=f.device)).tolist() if f.numel() else [0.0, 0.0]
    return {"fetch_max": int(f.max()) if f.numel() else 0, "fetch_p50": q[0], "fetch_p99": q[1]}


def bounce_rays(pathtracer, scene, origins, dirs, uniforms) -> list:
    """The (origins, dirs, active) of every traversal ``trace_paths`` makes
    on an all-opaque scene without shadow walks, in order: the primaries
    (active None), then each later bounce's rays: since K5, the whole batch
    with its live lanes first and its ``active`` mask (in a checkout from
    before K5, the live rays alone, active None)."""
    calls = []
    real = pathtracer.traverse

    def recording(nodes, root, depth, scale, o, d, *rest):
        calls.append((o, d, rest[1] if len(rest) > 1 else None))
        return real(nodes, root, depth, scale, o, d, *rest)

    pathtracer.traverse = recording
    try:
        pathtracer.trace_paths(scene, origins, dirs, uniforms)
    finally:
        pathtracer.traverse = real
    return calls


def shade_calls(pathtracer, scene, origins, dirs, uniforms) -> list:
    """The arguments ``(scene, st, u, res, is_first, may_scatter)`` of every
    ``_shade`` call one ``trace_paths`` frame makes, in order, and ``idx``
    seventh where the checkout gives the last bounce the lanes' index (the
    unpermute folded into the last bounce's stores; None on the other
    bounces): the primary bounce's lanes, then each later bounce's: since
    K5 the whole batch, its live lanes first (``int(st["active"].sum())`` of
    them); in a checkout from before K5, the live sub-batch."""
    calls = []
    real = pathtracer._shade

    def recording(*a):
        calls.append(a)
        return real(*a)

    pathtracer._shade = recording
    try:
        with torch.no_grad():
            pathtracer.trace_paths(scene, origins, dirs, uniforms)
    finally:
        pathtracer._shade = real
    return calls


def compaction_hook(pathtracer):
    """The name under which ``pathtracer``'s bounce loop calls K5:
    ``compact_for_bounce`` since its backward was folded into the bounces',
    ``compact`` in a checkout from before; None before K5."""
    return next((n for n in ("compact_for_bounce", "compact") if hasattr(pathtracer, n)), None)


def compact_calls(pathtracer, scene, origins, dirs, uniforms) -> list:
    """The arguments ``(st, uniforms, bounce, counts)`` of every K5
    compaction one ``trace_paths`` frame makes (bounces 2 to n), each state
    detached and cloned as the compaction found it."""
    calls = []
    hook = compaction_hook(pathtracer)
    real = getattr(pathtracer, hook)

    def recording(st, u, bounce, counts):
        calls.append(({k: None if v is None else v.detach().clone() for k, v in st.items()}, u, bounce,
                      None if counts is None else counts.clone()))
        return real(st, u, bounce, counts)

    setattr(pathtracer, hook, recording)
    try:
        with torch.no_grad():
            pathtracer.trace_paths(scene, origins, dirs, uniforms)
    finally:
        setattr(pathtracer, hook, real)
    return calls


def shade_gradients(pathtracer, scene, origins, dirs, uniforms) -> list:
    """The arguments of every K4 backward that one fwd+bwd of a
    ``trace_paths`` frame makes, as bench.py's step takes it (the mean
    radiance, with the atlas and the emittance taking gradient), in the
    forward's bounce order: ``(albedo, throughput, residual, emittance,
    atlas shape, g_throughput, g_radiance, g_albedo, need)``, then ``src``
    where the checkout folds the compaction's backward into K4's stores (the
    compaction's, or None on the first bounce) and ``idx`` where it folds the
    final unpermute into the last bounce's (None on the other bounces).
    Needs the card: the CPU's backward runs the twin."""
    from octree_pathtracing_tpu_torch.ops import shade as k4
    from octree_pathtracing_tpu_torch.parallel import apply_params

    calls = []
    real = k4._backward_cuda

    def recording(*a, **kw):
        calls.append(a + tuple(kw[k] for k in ("src", "idx") if k in kw))
        return real(*a, **kw)

    p = {"atlas": scene.atlas.detach().clone().requires_grad_(True),
         "emittance": scene.materials.emittance.detach().clone().requires_grad_(True)}
    k4._backward_cuda = recording
    try:
        pathtracer.trace_paths(apply_params(scene, p), origins, dirs, uniforms).mean().backward()
    finally:
        k4._backward_cuda = real
    return calls[::-1]


@contextlib.contextmanager
def unfolded(pathtracer):
    """The bounce loop of ``pathtracer`` as it ran before K7, K5's backward
    and the final unpermute were folded into the kernels that read their
    results: each bounce's K7 launch handed to K4 (the forward variant that
    reads it), the next-event walks' K7 launch over every shadow ray
    (``nee_setup`` writes no primitive slots), the compaction as an
    autograd node whose backward is ``compact_backward``
    (``ops/compact.compact``), and the last bounce storing its radiance in
    row order, then ``ops/compact.unpermute`` (the standalone kernel, and
    its gather back in the backward).  The folded route is held to it: the
    same radiance, bit for bit, and the same gradients."""
    from octree_pathtracing_tpu_torch.ops import compact as k5

    real_shade, real_compact = pathtracer._shade, pathtracer.compact_for_bounce

    def shade_with_k7(scene, st, u, res, is_first, may_scatter, idx=None):
        prim = pathtracer._prim_hit(scene, st["origin"], st["dir"]) if scene.prims is not None else None
        out = pathtracer.shade(scene, st, u, res, prim, is_first, may_scatter)
        radiance = pathtracer.nee(scene, st, u, out, prim_slots=False)
        return dict(out.state, radiance=radiance if idx is None else k5.unpermute(radiance, idx))

    pathtracer._shade, pathtracer.compact_for_bounce = shade_with_k7, k5.compact
    try:
        yield
    finally:
        pathtracer._shade, pathtracer.compact_for_bounce = real_shade, real_compact


def plant_soup(scene):
    """The plants of a ``plant_scene`` as a world-space quad soup: each plant
    voxel's cross quads offset to its corner.  Returns (origins, us, vs,
    materials) as numpy arrays."""
    from octree_pathtracing_tpu_torch.octree import enumerate_leaves, unpack_nodes
    from octree_pathtracing_tpu_torch.ops.traversal import FLAG_SIMPLE

    mask, data = unpack_nodes(scene.nodes.cpu().numpy())
    pos, _, val = enumerate_leaves(mask, data, scene.root, scene.depth)
    m = scene.models
    model = m.leaf_model.numpy()[val]
    quad = (m.flags.numpy()[model] & FLAG_SIMPLE) == 0
    pos, model = pos[quad], model[quad]
    start, count = m.quad_start.numpy()[model], m.quad_count.numpy()[model]
    qi = (start[:, None] + np.arange(int(count.max()))[None, :])[np.arange(int(count.max()))[None, :] < count[:, None]]
    corner = np.repeat(pos.astype(np.float32), count, axis=0)
    return (m.quads.origin.numpy()[qi] + corner, m.quads.u.numpy()[qi], m.quads.v.numpy()[qi],
            m.quads.material_id.numpy()[qi])


def plant_bvh_file(path: str, depth: int):
    """``build_bvh`` (leaves of 2) over the boxes of ``plant_scene(depth)``'s
    quad soup, padded by 1e-4, saved to ``path`` (an .npz with the soup);
    where ``path`` holds the build of the same soup it is loaded instead.
    Returns ({"plants", "quads", "seconds", "cached"}, the scene and its
    camera).  Host work only (about a minute of numpy at depth 9)."""
    import hashlib
    import time

    from octree_pathtracing_tpu_torch.models import plant_scene
    from octree_pathtracing_tpu_torch.ops.bvh import build_bvh

    scene, cam = plant_scene(depth=depth)
    o, u, v, mat = plant_soup(scene)
    digest = hashlib.sha256(b"".join(np.ascontiguousarray(x).tobytes() for x in (o, u, v, mat))).hexdigest()
    if os.path.exists(path):
        with np.load(path) as z:
            if str(z["digest"]) == digest:
                return dict(plants=len(o) // 4, quads=len(o), seconds=float(z["seconds"]), cached=True), scene, cam
    corners = np.stack([o, o + u, o + v, o + u + v])
    t0 = time.perf_counter()
    bvh = build_bvh(corners.min(0) - 1e-4, corners.max(0) + 1e-4)
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, digest=digest, seconds=seconds, o=o, u=u, v=v, mat=mat,
             **{f: getattr(bvh, f).numpy() for f in ("node_min", "node_max", "left", "right", "prim_order")})
    os.replace(tmp, path)
    return dict(plants=len(o) // 4, quads=len(o), seconds=seconds, cached=False), scene, cam


def _bits_differ(a, b):
    """(B,) bool: lanes where two outputs differ in any element (NaN equal
    to NaN)."""
    same = (a == b) | (a.isnan() & b.isnan()) if a.is_floating_point() else a == b
    return ~same.reshape(a.shape[0], -1).all(-1)


def check_shade(call, cot, need=(True, True, True, True), label: str = "") -> dict:
    """K4's acceptance gate on one ``shade`` call's arguments ``call``: the
    forward kernel against its twin on every output and the residual (at
    most 0.1% of the lanes outside rtol 1e-5 / atol 1e-6; where the call
    gives ``idx``, a frame's last bounce, the radiance stored through it
    and the backward's radiance cotangent read through it), then the
    backward kernel against the backward twin on the kernel's own forward
    outputs, the cotangents ``cot`` (g_throughput, g_radiance, g_albedo,
    each None for zero) and the gradients ``need``, within rtol 1e-5 /
    atol 1e-7 (float atomics add in the schedule's order).  Raises
    AssertionError naming ``label`` where either falls outside.  Returns
    {"lanes", "differ" (the lanes not bit-equal, field by field),
    "outside", "forward_err", "backward_err", "out", "resid",
    "backward_args" (the backward's arguments)}."""
    from octree_pathtracing_tpu_torch.ops import shade as k4

    k_out, k_res = k4._forward_cuda(k4._Call(*call), True)
    r_out, r_res = k4.shade_reference(*call)
    pairs = [(f, k_out.state[f], r_out.state[f]) for f in k4.STATE_KEYS]
    pairs += [(f, getattr(k_out, f), getattr(r_out, f)) for f in ("albedo", "hitpoint", "normal", "mat", "diffuse_on")]
    pairs += [("residual ints", k_res.ints, r_res.ints), ("residual floats", k_res.floats, r_res.floats)]
    lanes = int(call[1]["throughput"].shape[0])
    differ, outside, f_err = {}, torch.zeros(lanes, dtype=torch.bool, device=k_out.albedo.device), 0.0
    for f, k, r in pairs:
        k = k.to(r.dtype)
        differ[f] = int(_bits_differ(k, r).sum())
        if r.is_floating_point():
            ok = torch.isclose(k, r, rtol=1e-5, atol=1e-6) | (k.isnan() & r.isnan()) | ((k == r) & k.isinf())
            fin = torch.isfinite(k) & torch.isfinite(r)
            if bool(fin.any()):
                f_err = max(f_err, float((k - r)[fin].abs().max()))
            outside |= ~ok.reshape(lanes, -1).all(-1)
        else:
            outside |= _bits_differ(k, r)
    n_out = int(outside.sum())
    if n_out > 0.001 * lanes:
        raise AssertionError(f"K4's forward disagrees with its twin on {label}: {n_out} of {lanes} lanes outside "
                             f"rtol 1e-5 / atol 1e-6; lanes not bit-equal per field {differ}")
    scene, st = call[0], call[1]
    data = scene.atlas.data if hasattr(scene.atlas, "sizes") else scene.atlas
    args = (k_out.albedo, st["throughput"], k_res, scene.materials.emittance, tuple(data.shape), *cot, tuple(need))
    folded = {"idx": call[7]} if len(call) > 7 and call[7] is not None else {}  # a frame's last bounce
    got = k4._backward_cuda(*args, **folded)
    want = k4.shade_backward_reference(*args, **folded)
    b_err = 0.0
    for name, x, y in zip(("throughput", "radiance", "atlas", "emittance"), got, want):
        if (x is None) != (y is None):
            raise AssertionError(f"K4 backward {label} {name}: the kernel and its twin return different gradients")
        if x is not None:
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7,
                                       msg=lambda m, name=name: f"K4 backward {label} {name}: {m}")
            b_err = max(b_err, float((x - y).abs().max()) if x.numel() else 0.0)
    return {"lanes": lanes, "differ": differ, "outside": n_out, "forward_err": f_err, "backward_err": b_err,
            "out": k_out, "resid": k_res, "backward_args": args}


def nee_calls(pathtracer, scene, origins, dirs, uniforms) -> list:
    """The arguments ``(scene, st, u, out)`` of every next-event call
    (``ops/nee.nee``) of one ``trace_paths`` frame taken with bench.py's
    gradient (the mean radiance into the atlas and the emittance), in
    order, each followed by the radiance cotangent its backward received
    (None where it received none; on the last bounce of a checkout that
    folds the final unpermute into it, in the lanes' order)."""
    from octree_pathtracing_tpu_torch.ops import nee as k
    from octree_pathtracing_tpu_torch.parallel import apply_params

    calls, real, real_bwd = [], pathtracer.nee, k.NeeFunction.backward
    cots = []

    def recording(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    def recording_bwd(ctx, g):
        cots.append(g)
        return real_bwd(ctx, g)

    pathtracer.nee = recording
    k.NeeFunction.backward = staticmethod(recording_bwd)
    try:
        p = {"atlas": scene.atlas.detach().clone().requires_grad_(True),
             "emittance": scene.materials.emittance.detach().clone().requires_grad_(True)}
        pathtracer.trace_paths(apply_params(scene, p), origins, dirs, uniforms).mean().backward()
    finally:
        pathtracer.nee = real
        k.NeeFunction.backward = staticmethod(real_bwd)
    cots = cots[::-1] + [None] * (len(calls) - len(cots))
    return [(*c, g) for c, g in zip(calls, cots)]


def _gate(pairs, lanes: int, label: str, what: str) -> dict:
    """The forward gate on [(field, kernel, plain)], each lane-major over
    ``lanes`` rows: the rows not bit-equal, and those outside rtol 1e-5 /
    atol 1e-6 (integers exact), each at most 0.1% of the rows."""
    dev = pairs[0][1].device
    differ, any_differ, outside, err = {}, torch.zeros(lanes, dtype=torch.bool, device=dev), \
        torch.zeros(lanes, dtype=torch.bool, device=dev), 0.0
    for f, k, r in pairs:
        k, r = k.detach().reshape(lanes, -1).to(r.dtype), r.detach().reshape(lanes, -1)
        d = _bits_differ(k, r)
        differ[f] = int(d.sum())
        any_differ |= d
        if r.is_floating_point():
            ok = torch.isclose(k, r, rtol=1e-5, atol=1e-6) | (k.isnan() & r.isnan()) | ((k == r) & k.isinf())
            fin = torch.isfinite(k) & torch.isfinite(r)
            if bool(fin.any()):
                err = max(err, float((k - r)[fin].abs().max()))
            outside |= ~ok.all(-1)
        else:
            outside |= d
    n_diff, n_out = int(any_differ.sum()), int(outside.sum())
    if n_diff > 0.001 * lanes or n_out > 0.001 * lanes:
        raise AssertionError(f"{what} disagrees with its plain version on {label}: {n_diff} of {lanes} rows not "
                             f"bit-equal, {n_out} outside rtol 1e-5 / atol 1e-6; per field {differ}")
    return {"rows": lanes, "differ": differ, "not_bit_equal": n_diff, "outside": n_out, "max_abs_err": err}


def check_nee(call, g_radiance=None, label: str = "") -> dict:
    """The acceptance gate of K4's next-event kernels on one ``nee`` call's
    arguments ``call`` = (scene, st, u, out): ``nee_setup`` against
    ``nee_setup_reference`` on every ray field, ``nee_resolve`` against
    ``nee_resolve_reference`` on the kernel's rays and the same walks
    (radiance and residual), each bit-equal on all but 0.1% of its rows
    and within rtol 1e-5 / atol 1e-6 there; then ``nee_backward`` against
    ``nee_backward_reference`` on the kernel's residual and the radiance
    cotangent ``g_radiance`` (seeded ones where None), within rtol 1e-5 /
    atol 1e-7 (float atomics add in the schedule's order).  Raises
    AssertionError naming ``label``.  Returns {"setup", "resolve" (the
    gates' counts), "backward_err", "args" (what each kernel was given:
    "setup", "resolve", "backward")}."""
    from octree_pathtracing_tpu_torch.ops import nee as k

    scene, st, u, out = call
    plan = k.nee_plan(scene)
    c = k._Call(scene, plan, st["cur_mat"], u, out.hitpoint, out.normal, out.mat, out.diffuse_on)
    b = int(st["cur_mat"].shape[0])
    k_rays = k._setup_cuda(c)
    r_rays = k.nee_setup_reference(scene, plan, *c[2:])
    setup = _gate([(f, getattr(k_rays, f), getattr(r_rays, f)) for f in k.NeeRays._fields
                   if getattr(r_rays, f) is not None], plan.faces * b, label, "nee_setup")
    if getattr(k_rays, "p_hit", None) is not None and b:  # K7's scan folded in: its slots against K7 on every cast row
        from octree_pathtracing_tpu_torch.models.prims import intersect_prims

        k7 = intersect_prims(scene.prims, k_rays.origin, k_rays.dir, 1024.0)
        cast, fb = k_rays.active, plan.faces * b
        differ = {f: int((_bits_differ(a.view(torch.uint8).reshape(fb, -1), c.view(torch.uint8).reshape(fb, -1))
                          & cast).sum()) for f, a, c in zip(("hit", "t", "mat", "uv"), k_rays.prim[:4], k7[:4])}
        if any(differ.values()) or bool(k_rays.p_hit[~cast].any()):
            raise AssertionError(f"nee_setup's primitive slots disagree with K7 on {label}: cast rows not bit-equal "
                                 f"per field {differ}")
        setup["prim_rows"] = int(cast.sum())
    walk, prim = k.nee_walks(scene, plan, k_rays)
    tp, rad, alb = st["throughput"].detach(), out.state["radiance"].detach(), out.albedo.detach()
    k_out, k_res = k._resolve_cuda(c, k_rays, walk, prim, tp, rad, alb, True)
    r_out, r_res = k.nee_resolve_reference(scene, plan, k_rays, walk, prim, alb, tp, rad, st["cur_mat"])
    resolve = _gate([("radiance", k_out, r_out)], b, label, "nee_resolve")
    resid = _gate([("residual ints", k_res.ints, r_res.ints)], plan.faces * b, label, "nee_resolve's residual")
    resolve["residual"] = resid
    if g_radiance is None:
        g = torch.Generator().manual_seed(b)
        g_radiance = (torch.rand((b, 3), generator=g) + 0.5).to(tp.device)
    data = scene.atlas.data if hasattr(scene.atlas, "sizes") else scene.atlas
    args = (alb, tp, k_res, data, scene.materials.emittance, scene.sun.emittance, plan, g_radiance,
            (True, True, True, True, True))
    got, want = k._backward_cuda(*args), k.nee_backward_reference(*args)
    got, want = ([None if x is None else x.detach() for x in r] for r in (got, want))
    b_err = 0.0
    for name, x, y in zip(("throughput", "radiance", "albedo", "atlas", "emittance"), got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7, msg=lambda m, name=name: f"nee_backward {label} {name}: {m}")
        b_err = max(b_err, float((x - y).abs().max()) if x.numel() else 0.0)
    return {"setup": setup, "resolve": resolve, "backward_err": b_err, "rays": k_rays, "walk": (walk, prim),
            "args": {"setup": (c,), "resolve": (c, k_rays, walk, prim, tp, rad, alb, False), "backward": args}}


def check_compact(st, uniforms, bounce: int, label: str = "") -> dict:
    """K5's acceptance gate on one compaction's arguments: the kernel
    against ``compact_reference`` bit for bit on every output (the state
    fields, the carried index, the bounce's uniforms, ``pos``, the live
    count), the backward kernel against ``compact_backward_reference`` bit
    for bit on seeded cotangents of the throughput and the radiance, and the
    unpermute and its backward against theirs on the compacted radiance.
    Raises AssertionError naming ``label``.  Returns {"lanes", "live",
    "forward" (the kernel's outputs), "backward_args", "unpermute_args"}."""
    from octree_pathtracing_tpu_torch.ops import compact as k5

    b, n_b = int(st["active"].shape[0]), int(uniforms.shape[1])
    counts = torch.full((n_b,), -1, dtype=torch.int32, device=st["active"].device)
    r_counts = counts.cpu()
    k_out, k_u, k_pos = k5._forward_cuda(st, uniforms, bounce, counts)
    r_out, r_u, r_pos = k5.compact_reference({k: None if v is None else v.cpu() for k, v in st.items()},
                                             uniforms.cpu(), bounce, r_counts)
    pairs = [(k, k_out[k], r_out[k]) for k in r_out] + [("uniforms", k_u, r_u), ("pos", k_pos, r_pos),
                                                        ("counts", counts, r_counts)]
    differ = {f: int(_bits_differ(k.cpu().reshape(max(1, k.shape[0]), -1), r.reshape(max(1, r.shape[0]), -1)).sum())
              for f, k, r in pairs if k.numel()}
    if any(differ.values()):
        raise AssertionError(f"K5 disagrees with its plain version on {label}: rows not bit-equal per field {differ}")
    g = torch.Generator().manual_seed(b)
    g_tp, g_rad = ((torch.rand((b, 3), generator=g) - 0.5).to(k_pos.device) for _ in range(2))
    got, want = k5._backward_cuda(k_pos, g_tp, g_rad), k5.compact_backward_reference(k_pos.cpu(), g_tp.cpu(), g_rad.cpu())
    if not all(torch.equal(x.cpu(), y) for x, y in zip(got, want)):
        raise AssertionError(f"K5's backward disagrees with its plain version on {label}")
    rad, idx = k_out["radiance"], k_out["idx"]
    scattered = k5._unpermute_cuda(rad, idx, True)
    gathered = k5._unpermute_cuda(g_tp, idx, False)
    if not (torch.equal(scattered.cpu(), k5.unpermute_reference(rad.cpu(), idx.cpu()))
            and torch.equal(gathered.cpu(), k5.unpermute_backward_reference(g_tp.cpu(), idx.cpu()))):
        raise AssertionError(f"the unpermute disagrees with its plain version on {label}")
    return {"lanes": b, "live": int(r_counts[bounce]), "forward": (k_out, k_u, k_pos),
            "backward_args": (k_pos, g_tp, g_rad), "unpermute_args": (rad, idx, g_tp)}


def argsort_route(st, uniforms, bounce: int):
    """K5's function through library calls, the yardstick: a stable
    ``torch.argsort`` of the dead flags, then one ``index_select`` per field
    and of the bounce's uniforms."""
    perm = torch.argsort(~st["active"], stable=True)
    out = {k: v.index_select(0, perm) for k, v in st.items() if v is not None}
    idx = out.get("idx", perm)
    return out, uniforms[:, bounce].index_select(0, idx.long())


def nonzero_route(st, uniforms, bounce: int):
    """The parent's K5 (before the kernel): the live lanes by ``nonzero``
    (a read of the count back to the host), their fields and uniforms
    gathered, and each field ``index_put`` back after the bounce (here with
    the gathered rows themselves)."""
    idx = st["active"].nonzero().squeeze(1)
    sub = {k: v[idx] for k, v in st.items() if v is not None and k != "idx"}
    u = uniforms[idx, bounce]
    return {k: st[k].index_put((idx,), sub[k]) for k in sub}, u


def capture_frame(fn):
    """(graph, output): ``fn()`` (a frame that reads nothing from the card)
    warmed up on a side stream, then captured in a CUDA graph.  A capture
    that fails raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def replay_ms(graph, replays: int = 20) -> list:
    """Device ms of each of ``replays`` replays of ``graph`` (CUDA events),
    after one."""
    graph.replay()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def profiled_names(fn) -> list:
    """The names of the device activities torch.profiler records over one
    call of ``fn`` (which synchronizes the card), in order.  A session can
    drop the first activities after it starts (on the card, a long-running
    process's sessions have dropped a frame's first two to six), so each
    session runs ``fn`` twice, the calls parted by spin kernels, and only
    what follows the last spin kernel, the second call, is returned."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(10000)
        fn()
        for _ in range(4):
            torch.cuda._sleep(10000)
        fn()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spins = [i for i, n in enumerate(names) if "spin" in n.lower()]
    return names[spins[-1] + 1:] if spins else []


def profile_launches(fn, tries: int = 3, ours: tuple = (), expect_ours: int | None = None) -> dict:
    """{"kernels", "memsets", "memcpys", "sessions"}: the device activities
    torch.profiler records over one call of ``fn`` (which synchronizes the
    card; :func:`profiled_names`); where ``ours`` is given, also "ours",
    the kernels whose names hold one of ``ours``, and "others", the names of
    the rest.  ``tries`` sessions are taken and the fullest one counts.
    ``expect_ours``: how many of ``ours`` one call launches (their wrappers'
    counts); sessions then go on, up to ``4 * tries``, until one shows
    exactly that many, and the fullest of those counts ("ours" says whether
    one did)."""

    def summary(names):
        n_ours = sum(any(k in n for k in ours) for n in names)
        return (expect_ours is None or n_ours == expect_ours, len(names)), n_ours

    fn()
    best, best_key, sessions = [], (False, -1), 0
    while sessions < tries or (not best_key[0] and sessions < 4 * tries):
        sessions += 1
        names = profiled_names(fn)
        key = summary(names)[0]
        if key > best_key:
            best, best_key = names, key
    memsets = sum(n.startswith("Memset") for n in best)
    memcpys = sum(n.startswith("Memcpy") for n in best)
    out = {"kernels": len(best) - memsets - memcpys, "memsets": memsets, "memcpys": memcpys, "sessions": sessions}
    if ours:
        out["ours"] = summary(best)[1]
        out["others"] = [n for n in best if not (n.startswith(("Memset", "Memcpy")) or any(k in n for k in ours))]
    return out


def kernel_names(root=None) -> tuple:
    """The names of the port's own CUDA kernels (every ``__global__``
    function of ``csrc/*.cu`` under the package at ``root``, by default
    this one), as torch.profiler shows them within each kernel's name."""
    import glob
    import re

    root = root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = set()
    for path in glob.glob(os.path.join(root, "csrc", "*.cu")):
        with open(path) as f:
            names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\(\w+\)\s+)?(\w+)\s*\(", f.read()))
    return tuple(sorted(names))


def radiance_digest(radiance) -> str:
    """sha256 of a frame's radiance bytes: two checkouts' frames compare
    bit for bit across processes."""
    import hashlib

    return hashlib.sha256(radiance.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def host_ms(fn, runs: int = 5) -> list:
    """Host-clock ms of ``runs`` calls of ``fn`` after one warm-up, each
    ending in ``torch.cuda.synchronize()``."""
    import time

    times = []
    for i in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def _shade_cases(dev, cache_dir) -> dict:
    """K4's rows, whatever shading the checkout has: ``_shade`` on each
    bounce of one headline frame (forward, and forward with its backward),
    and the frame itself (forward and bench.py's fwd+bwd: host ms and the
    launches torch.profiler counts)."""
    import statistics

    from octree_pathtracing_tpu_torch.models import minecraft_chunk_scene, pixel_grid_rays
    from octree_pathtracing_tpu_torch.parallel import apply_params
    from octree_pathtracing_tpu_torch.render import pathtracer

    scene, cam = minecraft_chunk_scene(depth=9, cache_dir=cache_dir)
    scene, cam = scene.to(dev), cam.to(dev)
    o, d = pixel_grid_rays(cam, 256, 256)
    u = pathtracer.draw_uniforms(1, 0, 256 * 256, 5, dev)

    def params():
        return {"atlas": scene.atlas.detach().clone().requires_grad_(True),
                "emittance": scene.materials.emittance.detach().clone().requires_grad_(True)}

    out = {}
    for k, (_, st, uu, res, *flags) in enumerate(shade_calls(pathtracer, scene, o, d, u), start=1):
        def fwd(st=st, uu=uu, res=res, flags=flags):
            return pathtracer._shade(scene, st, uu, res, *flags)

        def fwd_bwd(st=st, uu=uu, res=res, flags=flags):
            sp = apply_params(scene, params())
            s = dict(st, throughput=st["throughput"].clone().requires_grad_(True))
            r = pathtracer._shade(sp, s, uu, res, *flags)
            (r["throughput"].sum() + r["radiance"].sum()).backward()

        row = both(fwd)
        row.update(lanes=int(st["throughput"].shape[0]), live=int(st["active"].sum()),
                   fwd_bwd_call_ms=call_ms(fwd_bwd, 20))
        out[f"K4 _shade headline bounce {k}"] = row
    if hasattr(pathtracer, "shade"):  # the backward alone, on the cotangents a real fwd+bwd hands each bounce
        from octree_pathtracing_tpu_torch.ops import shade as k4

        for k, args in enumerate(shade_gradients(pathtracer, scene, o, d, u), start=1):
            row = both(lambda args=args: k4._backward_cuda(*args))
            row.update(lanes=int(args[0].shape[0]))
            out[f"K4 backward headline bounce {k}"] = row

    def frame_fwd_bwd():
        pathtracer.trace_paths(apply_params(scene, params()), o, d, u).mean().backward()

    for name, fn in (("frame forward", lambda: pathtracer.trace_paths(scene, o, d, u)),
                     ("frame fwd+bwd", frame_fwd_bwd)):
        times = host_ms(fn)

        def synced(fn=fn):
            fn()
            torch.cuda.synchronize()

        out[f"headline {name}"] = {"host_ms": statistics.median(times), "host_ms_runs": times,
                                   **profile_launches(synced)}
    out["headline frame forward"]["radiance_sha256"] = radiance_digest(pathtracer.trace_paths(scene, o, d, u))
    if compaction_hook(pathtracer):  # since K5 the forward frame captures: its replays are its device time
        out["headline frame forward, CUDA graph replay"] = _graph_frame_case(scene, o, d, u)
    return out


def _k4_cases(dev, cache_dir) -> dict:
    """``--k4``: K4's rows of the headline (``_shade_cases``) and of the
    analytic scene (``_prim_cases``)."""
    out = _shade_cases(dev, cache_dir)
    out.update(_prim_cases(dev, cache_dir))
    return out


def _prim_cases(dev, cache_dir, frames: bool = False) -> dict:
    """The primitives' share of a bounce on the depth-9 analytic scene
    (256x256, the uniforms of seed 1), whatever the checkout does with
    them: under IMPORTANCE ``_shade`` on each bounce (K7 and K4, or K4 with
    K7's scan folded in), by call and on the device; under HIGH_QUALITY
    ``nee_setup`` on each bounce with K7 over its rays where the checkout
    launches it apart (or ``nee_setup`` with the scan folded in).
    ``frames`` (``--prims``): the two analytic lines' frames too
    (``_light_lines``)."""
    import dataclasses

    from octree_pathtracing_tpu_torch.models import analytic_sphere_scene, pixel_grid_rays
    from octree_pathtracing_tpu_torch.models.prims import intersect_prims
    from octree_pathtracing_tpu_torch.models.sun import SunSampling
    from octree_pathtracing_tpu_torch.ops import nee as nee_mod
    from octree_pathtracing_tpu_torch.render import pathtracer

    scene, cam = analytic_sphere_scene(depth=9)
    scene, cam = scene.to(dev), cam.to(dev)
    o, d = pixel_grid_rays(cam, 256, 256)
    u = pathtracer.draw_uniforms(1, 0, 256 * 256, 5, dev)
    out = {}
    for k, (_, st, uu, res, *flags) in enumerate(shade_calls(pathtracer, scene, o, d, u), start=1):
        row = both(lambda st=st, uu=uu, res=res, flags=flags: pathtracer._shade(scene, st, uu, res, *flags))
        out[f"K7 + K4 _shade analytic bounce {k}"] = dict(row, lanes=int(st["throughput"].shape[0]),
                                                         live=int(st["active"].sum()))
    hq = dataclasses.replace(scene, sun_sampling=SunSampling.high_quality())
    for k, call in enumerate(nee_calls(pathtracer, hq, o, d, u), start=1):
        sc, st, uu, sh = call[:4]
        c = nee_mod._Call(sc, nee_mod.nee_plan(sc), st["cur_mat"], uu, sh.hitpoint, sh.normal, sh.mat, sh.diffuse_on)

        def setup_and_k7(c=c):
            rays = nee_mod._setup_cuda(c)
            if getattr(rays, "p_hit", None) is None:  # K7 over the rays, as the walks launch it
                intersect_prims(c.scene.prims, rays.origin, rays.dir, 1024.0)

        out[f"nee_setup + K7 analytic_hq bounce {k}"] = dict(both(setup_and_k7), lanes=int(st["cur_mat"].shape[0]),
                                                             live=int(st["active"].sum()))
    if frames:
        lines = tuple(x for x in LIGHT_LINES if x[1] == "analytic")
        out.update(_light_lines(dev, cache_dir, None, lines, {"analytic": (scene, cam)}))
    return out


def _graph_fwd_bwd_case(scene, o, d, u) -> dict:
    """bench.py's fwd+bwd step (the mean radiance into the atlas and the
    emittance) captured whole in a CUDA graph: {"replay_ms" (the median),
    "replay_ms_runs", "bit_equal" (a replay's radiance against the eager
    step's), "grads_within_gate" (its gradients within rtol 1e-5 / atol
    1e-7 of the eager step's: float atomics add in the schedule's order)}."""
    import statistics

    from octree_pathtracing_tpu_torch.parallel import apply_params
    from octree_pathtracing_tpu_torch.render import pathtracer

    p = {"atlas": scene.atlas.detach().clone().requires_grad_(True),
         "emittance": scene.materials.emittance.detach().clone().requires_grad_(True)}

    def step():
        for v in p.values():
            v.grad = None
        rad = pathtracer.trace_paths(apply_params(scene, p), o, d, u)
        rad.mean().backward()
        return rad

    eager = step().detach().clone()
    grads = {k: v.grad.clone() for k, v in p.items()}
    graph, rad = capture_frame(step)
    rad.detach().view(torch.uint8).fill_(0xFF)  # spoiled: the replays must write them again
    for v in p.values():
        v.grad.fill_(float("nan"))
    times = replay_ms(graph)
    close = all(torch.allclose(p[k].grad, g, rtol=1e-5, atol=1e-7) for k, g in grads.items())
    return {"replay_ms": statistics.median(times), "replay_ms_runs": times,
            "bit_equal": bool(torch.equal(rad.detach(), eager)), "grads_within_gate": close}


def _graph_frame_case(scene, o, d, u) -> dict:
    """A forward frame captured in a CUDA graph: {"replay_ms" (the median),
    "replay_ms_runs", "bit_equal" (a replay against the eager frame)}."""
    import statistics

    from octree_pathtracing_tpu_torch.render import pathtracer

    eager = pathtracer.trace_paths(scene, o, d, u)
    graph, replayed = capture_frame(lambda: pathtracer.trace_paths(scene, o, d, u))
    times = replay_ms(graph)
    return {"replay_ms": statistics.median(times), "replay_ms_runs": times,
            "bit_equal": bool(torch.equal(replayed, eager))}


def tiled_compaction(call, times: int):
    """A compaction's arguments repeated ``times`` times over the lanes (the
    carried index kept a permutation): the same live share at a larger
    batch."""
    st, u, bounce, counts = call
    b = st["active"].shape[0]
    big = {k: None if v is None else v.repeat((times,) + (1,) * (v.dim() - 1)) for k, v in st.items()}
    if big.get("idx") is not None:
        big["idx"] = (big["idx"].view(times, b) + b * torch.arange(times, device=u.device, dtype=torch.int32)[:, None]
                      ).reshape(-1)
    return big, u.repeat(times, 1, 1), bounce, counts


def _compact_cases(dev, cache_dir) -> dict:
    """K5's rows, in a checkout that has it: the forward and the backward on
    the compactions of one headline frame (bounces 2-5) and on the bounce-2
    state repeated to 2,097,152 lanes, each checked bit for bit first, by
    call and on the device, beside the plain version on the card and two
    library routes (``argsort_route``, ``nonzero_route``); the unpermute and
    its backward on the frame's last state."""
    from octree_pathtracing_tpu_torch.models import minecraft_chunk_scene, pixel_grid_rays
    from octree_pathtracing_tpu_torch.ops import compact as k5
    from octree_pathtracing_tpu_torch.render import pathtracer

    scene, cam = minecraft_chunk_scene(depth=9, cache_dir=cache_dir)
    scene, cam = scene.to(dev), cam.to(dev)
    o, d = pixel_grid_rays(cam, 256, 256)
    u = pathtracer.draw_uniforms(1, 0, 256 * 256, 5, dev)
    calls = compact_calls(pathtracer, scene, o, d, u)
    cases = [(f"headline bounce {c[2] + 1}", c) for c in calls] + [("2,097,152 lanes", tiled_compaction(calls[0], 32))]
    out, last = {}, None
    for label, (st, uu, bounce, counts) in cases:
        chk = check_compact(st, uu, bounce, label)
        if chk["lanes"] == 256 * 256:
            last = chk
        pos, g_tp, g_rad = chk["backward_args"]
        big = chk["lanes"] > 1 << 20
        rows = {"K5 compact_forward": lambda: k5._forward_cuda(st, uu, bounce, counts),
                "K5 compact_backward": lambda: k5._backward_cuda(pos, g_tp, g_rad),
                "argsort + index_select": lambda: argsort_route(st, uu, bounce),
                "nonzero + gathers + index_put": lambda: nonzero_route(st, uu, bounce)}
        for name, fn in rows.items():
            dms, how = device_ms(fn, calls=10 if big else GRAPH_CALLS)
            row = {"call_ms": call_ms(fn, 20 if big else CALLS), "device_ms": dms, "device_by": how,
                   "lanes": chk["lanes"], "live": chk["live"]}
            if name == "K5 compact_forward":
                row["plain_ms"] = call_ms(lambda: k5.compact_reference(st, uu, bounce), 5)
            out[f"{name} {label}"] = row
    rad, idx, g = last["unpermute_args"]  # the last bounce's
    for name, scatter, x in (("K5 unpermute", True, rad), ("K5 unpermute backward", False, g)):
        row = both(lambda scatter=scatter, x=x: k5._unpermute_cuda(x, idx, scatter))
        out[f"{name} headline"] = dict(row, lanes=int(idx.shape[0]))
    return out


def _nee_bounce_cases(dev, cache_dir) -> dict:
    """The next-event kernels on each bounce of one frame of the NEE line
    (the depth-9 terrain under the HIGH_QUALITY sun, 256x256, the uniforms of
    seed 1), checked against their plain versions first: ``nee_setup``,
    ``nee_resolve`` and ``nee_backward`` by call and on the device, with the
    lanes and live lanes each was given (the live sub-batch before K5)."""
    import dataclasses

    from octree_pathtracing_tpu_torch.models import minecraft_chunk_scene, pixel_grid_rays
    from octree_pathtracing_tpu_torch.models.sun import SunSampling
    from octree_pathtracing_tpu_torch.ops import nee as nee_mod
    from octree_pathtracing_tpu_torch.render import pathtracer

    scene, cam = minecraft_chunk_scene(depth=9, cache_dir=cache_dir)
    scene = dataclasses.replace(scene, sun_sampling=SunSampling.high_quality()).to(dev)
    o, d = pixel_grid_rays(cam.to(dev), 256, 256)
    u = pathtracer.draw_uniforms(1, 0, 256 * 256, 5, dev)
    out = {}
    for k, call in enumerate(nee_calls(pathtracer, scene, o, d, u), start=1):
        chk = check_nee(call[:4], call[4], f"the NEE line's bounce {k}")
        args = chk["args"]
        c = args["setup"][0]
        extra = {"lanes": int(c.cur_mat.shape[0]), "live": int(call[1]["active"].sum())}
        for name, fn in (("nee_setup", lambda: nee_mod._setup_cuda(c)),
                         ("nee_resolve", lambda: nee_mod._resolve_cuda(*args["resolve"])),
                         ("nee_backward", lambda: nee_mod._backward_cuda(*args["backward"]))):
            out[f"{name} NEE line bounce {k}"] = dict(both(fn), **extra)
    return out


# (line, scene, sun, emitter sampling) of the light lines' frames
LIGHT_LINES = (("nee", "terrain", "high_quality", "none"), ("cutout", "cutout", "high_quality", "none"),
               ("config3", "terrain", "high_quality", "one"), ("plant", "plant", "high_quality", "none"),
               ("analytic", "analytic", "importance", "none"), ("analytic_hq", "analytic", "high_quality", "none"),
               ("world", "world", "high_quality", "one"))


def _light_lines(dev, cache_dir, world, lines=LIGHT_LINES, scenes=None) -> dict:
    """The light lines' frames at the headline's shape (256x256, 5 bounces,
    depth 9, the uniforms of seed 1), forward and with bench.py's backward:
    host ms (median of 5) and the device activities torch.profiler counts in
    one frame; in a checkout with the next-event kernels, also through their
    plain version (``plain_nee``); in a checkout with K5, each frame's CUDA
    graph replay (``graph``: its device floor, or the capture's error; the
    fwd+bwd step's with its gradients checked, ``_graph_fwd_bwd_case``).
    ``world``: a region file, or None; ``lines``: (name, scene,
    sun, emitter sampling) of each frame; ``scenes``: {scene: (scene,
    camera)} on the card already built (the rest are built here)."""
    import dataclasses
    import statistics

    from octree_pathtracing_tpu_torch.models import (
        analytic_sphere_scene,
        cutout_chunk_scene,
        minecraft_chunk_scene,
        minecraft_scene_from_region,
        pixel_grid_rays,
        plant_scene,
    )
    from octree_pathtracing_tpu_torch.models.emitters import with_emitter_sampling
    from octree_pathtracing_tpu_torch.models.sun import SunSampling
    from octree_pathtracing_tpu_torch.parallel import apply_params
    from octree_pathtracing_tpu_torch.render import pathtracer

    try:
        from octree_pathtracing_tpu_torch.ops import nee as nee_mod
    except ImportError:  # a checkout from before the next-event kernels: its path is the eager one
        nee_mod = None
    builds = {"terrain": lambda: minecraft_chunk_scene(depth=9, cache_dir=cache_dir),
              "cutout": lambda: cutout_chunk_scene(depth=9, cache_dir=cache_dir),
              "plant": lambda: plant_scene(depth=9), "analytic": lambda: analytic_sphere_scene(depth=9)}
    if world:
        builds["world"] = lambda: minecraft_scene_from_region(world, depth=9)
    u = pathtracer.draw_uniforms(1, 0, 256 * 256, 5, dev)
    scenes, out = dict(scenes or {}), {}
    for name, which, sun, sampling in lines:
        if which not in builds and which not in scenes:
            continue
        if which not in scenes:
            sc, cam = builds[which]()
            scenes[which] = (sc.to(dev), cam.to(dev))
        sc, cam = scenes[which]
        sc = with_emitter_sampling(dataclasses.replace(sc, sun_sampling=getattr(SunSampling, sun)()), sampling)
        o, d = pixel_grid_rays(cam, 256, 256)

        def fwd(sc=sc, o=o, d=d):
            pathtracer.trace_paths(sc, o, d, u)

        def fwd_bwd(sc=sc, o=o, d=d):
            p = {"atlas": sc.atlas.detach().clone().requires_grad_(True),
                 "emittance": sc.materials.emittance.detach().clone().requires_grad_(True)}
            pathtracer.trace_paths(apply_params(sc, p), o, d, u).mean().backward()

        for step, fn in (("forward", fwd), ("fwd+bwd", fwd_bwd)):
            def synced(fn=fn):
                fn()
                torch.cuda.synchronize()

            times = host_ms(fn)
            row = {"host_ms": statistics.median(times), "host_ms_runs": times, **profile_launches(synced)}
            if step == "forward":
                row["radiance_sha256"] = radiance_digest(pathtracer.trace_paths(sc, o, d, u))
            if compaction_hook(pathtracer):  # since K5: the frame's device floor, its graph's replay
                try:
                    row["graph"] = (_graph_frame_case if step == "forward" else _graph_fwd_bwd_case)(sc, o, d, u)
                except RuntimeError as e:  # said on the row: a host read in this line's frame
                    torch.cuda.synchronize()
                    row["graph"] = {"error": f"{type(e).__name__}: {e}"}
            if nee_mod is not None and nee_mod.nee_plan(sc) is not None:
                real = pathtracer.nee
                pathtracer.nee = lambda *a, **kw: nee_mod.nee_reference(*a, **kw)[0]
                try:
                    row["plain_nee"] = profile_launches(synced)
                finally:
                    pathtracer.nee = real
            out[f"{name} line {step}"] = row
    return out


# (line, scene, emitter sampling) of the next-event rows, under the HIGH_QUALITY sun
NEE_LINES = (("nee", "terrain", "none"), ("cutout", "cutout", "none"), ("config3", "terrain", "one"),
             ("world", "world", "one"))


def _time_nee(dev, cache_dir, world=None) -> dict:
    """The next-event kernels alone (``--nee``: an A/B of their design):
    ``nee_setup``, ``nee_resolve`` and ``nee_backward`` on each bounce of one
    frame of the NEE, cutout, config-3 and (with ``world``) world lines,
    each checked against its plain version first (``check_nee``) and timed
    by call and on the device, with its lanes, live lanes, faces and cast
    rays; then the light lines' frames and the headline's, forward and
    fwd+bwd, with their device activities (``_light_lines``)."""
    import dataclasses

    from octree_pathtracing_tpu_torch.models import (
        cutout_chunk_scene,
        minecraft_chunk_scene,
        minecraft_scene_from_region,
        pixel_grid_rays,
    )
    from octree_pathtracing_tpu_torch.models.emitters import with_emitter_sampling
    from octree_pathtracing_tpu_torch.models.sun import SunSampling
    from octree_pathtracing_tpu_torch.ops import nee as nee_mod
    from octree_pathtracing_tpu_torch.render import pathtracer

    scenes = {"terrain": minecraft_chunk_scene(depth=9, cache_dir=cache_dir),
              "cutout": cutout_chunk_scene(depth=9, cache_dir=cache_dir)}
    if world:
        scenes["world"] = minecraft_scene_from_region(world, depth=9)
    scenes = {k: (sc.to(dev), cam.to(dev)) for k, (sc, cam) in scenes.items()}
    u = pathtracer.draw_uniforms(1, 0, 256 * 256, 5, dev)
    out = {}
    for line, which, sampling in NEE_LINES:
        if which not in scenes:
            continue
        sc, cam = scenes[which]
        sc = with_emitter_sampling(dataclasses.replace(sc, sun_sampling=SunSampling.high_quality()), sampling)
        o, d = pixel_grid_rays(cam, 256, 256)
        for k, call in enumerate(nee_calls(pathtracer, sc, o, d, u), start=1):
            chk = check_nee(call[:4], call[4], f"the {line} line's bounce {k}")
            args = chk["args"]
            c = args["setup"][0]
            extra = {"lanes": int(c.cur_mat.shape[0]), "live": int(call[1]["active"].sum()), "faces": c.plan.faces,
                     "cast": int(chk["rays"].active.sum())}
            for name, fn in (("nee_setup", lambda: nee_mod._setup_cuda(c)),
                             ("nee_resolve", lambda: nee_mod._resolve_cuda(*args["resolve"])),
                             ("nee_backward", lambda: nee_mod._backward_cuda(*args["backward"]))):
                out[f"{name} {line} line bounce {k}"] = dict(both(fn), **extra)
    lines = LIGHT_LINES + (("headline", "terrain", "importance", "none"),)
    out.update(_light_lines(dev, cache_dir, world, lines, scenes))
    return out


def _k1_bounce_cases(dev, terrain, cam) -> dict:
    """name -> ((call, its twin), arguments): K1 on bounces 2-5 of one
    headline frame (the uniforms of seed 1): the whole batch with its
    ``active`` mask since K5, the live rays before it."""
    from octree_pathtracing_tpu_torch.models import pixel_grid_rays
    from octree_pathtracing_tpu_torch.ops import traversal as tv
    from octree_pathtracing_tpu_torch.render import pathtracer

    o, d = pixel_grid_rays(cam, 256, 256)
    u = pathtracer.draw_uniforms(1, 0, 256 * 256, 5, dev)
    head = (terrain.nodes, terrain.root, terrain.depth, terrain.octree_scale)
    return {f"K1 headline bounce {k}": ((tv.traverse, tv.traverse_reference),
                                         head + (bo.contiguous(), bd.contiguous(), 1024.0, act))
            for k, (bo, bd, act) in enumerate(bounce_rays(pathtracer, terrain, o, d, u)[1:], start=2)}


def _time_traversals(cases) -> dict:
    """Each traversal case checked bit for bit against its twin, then timed
    by call and on the device, with its lanes, live lanes and fetches."""
    out = {}
    for name, ((kernel, twin), args) in cases.items():
        k = kernel(*args)
        if not _equal(k, twin(*args)):
            raise AssertionError(f"{name}: the kernel disagrees with its twin")
        big = args[4].shape[0] > 1 << 20  # the training views: fewer calls
        dms, how = device_ms(lambda: kernel(*args), calls=10 if big else GRAPH_CALLS)
        active = args[7] if len(args) > 7 and isinstance(args[7], torch.Tensor) else None
        out[name] = {"call_ms": call_ms(lambda: kernel(*args), 20 if big else CALLS), "device_ms": dms,
                     "device_by": how, "lanes": int(args[4].shape[0]),
                     "live": int(args[4].shape[0]) if active is None else int(active.sum()), **fetch_stats(k.fetches)}
    return out


def _traversal_cases(dev, cache_dir) -> dict:
    """name -> ((call, its twin), arguments): the traversal rows."""
    from octree_pathtracing_tpu_torch import cli
    from octree_pathtracing_tpu_torch.models import (
        cutout_chunk_scene,
        face_normals,
        minecraft_chunk_scene,
        pixel_grid_rays,
        plant_scene,
    )
    from octree_pathtracing_tpu_torch.models.sun import random_sun_direction
    from octree_pathtracing_tpu_torch.ops import traversal as tv
    from octree_pathtracing_tpu_torch.ops.shading import OFFSET
    from octree_pathtracing_tpu_torch.render.hit import accept_tables, resolve_hit

    depth, side, views, view_side = 9, 256, 8, 512
    terrain, cam = minecraft_chunk_scene(depth=depth, cache_dir=cache_dir)
    cut, cut_cam = cutout_chunk_scene(depth=depth, cache_dir=cache_dir)
    plant, plant_cam = plant_scene(depth=depth)
    terrain, cam, cut, cut_cam = terrain.to(dev), cam.to(dev), cut.to(dev), cut_cam.to(dev)
    plant, plant_cam = plant.to(dev), plant_cam.to(dev)

    def head(sc, o, d):
        return (sc.nodes, sc.root, sc.depth, sc.octree_scale, o.contiguous(), d.contiguous())

    def training(sc):
        rays = [pixel_grid_rays(c.to(dev), view_side, view_side) for c in cli.orbit_cameras(sc.depth, views)]
        return head(sc, torch.cat([r[0] for r in rays]), torch.cat([r[1] for r in rays]))

    cases = {}
    prim = head(terrain, *pixel_grid_rays(cam, side, side))
    cases[f"K1 terrain {side}^2 primaries"] = ((tv.traverse, tv.traverse_reference), prim)
    cases.update(_k1_bounce_cases(dev, terrain, cam))
    cut_tables, terrain_tables, plant_tables = accept_tables(cut), accept_tables(terrain), accept_tables(plant)
    cprim = head(cut, *pixel_grid_rays(cut_cam, side, side))
    alpha = (tv.traverse_alpha, tv.traverse_alpha_reference)
    cases[f"K2 cutout {side}^2 primaries"] = (alpha, cprim + (cut_tables,))
    cases[f"K2 cutout {views} x {view_side}^2 views"] = (alpha, training(cut) + (cut_tables,))
    record = (lambda *a: tv.traverse_record(*a)[0], lambda *a: tv.traverse_record_reference(*a)[0])
    cases[f"K3r terrain {views} x {view_side}^2 views"] = (record, training(terrain) + (terrain_tables,))
    # K3s: the cutout's sun walk from its primaries' hits (strict, no t)
    first = tv.traverse_alpha(*cprim, cut_tables)
    hn = face_normals(dev)[first.face_id.clamp(0, 5).long()]
    hp = torch.where(first.hit[:, None], cprim[4] + cprim[5] * first.t[:, None], cprim[4])
    su = torch.from_numpy(np.random.default_rng(11).random((side * side, 5), dtype=np.float32)).to(dev)
    sun = random_sun_direction(cut.sun, su[:, 0], su[:, 1]).contiguous()
    front = (sun * hn).sum(-1) > 0.0
    air = torch.zeros((side * side,), dtype=torch.int32, device=dev)
    so = (torch.where(front[:, None], hp, hp - OFFSET * hn) + sun * OFFSET).contiguous()
    shadow = (lambda *a: tv.traverse_shadow(*a)[0], lambda *a: tv.traverse_shadow_reference(*a)[0])
    cases["K3s cutout sun walk"] = (shadow, head(cut, so, sun) + (cut_tables, air, True, False, 1024.0,
                                                                  first.hit & front))
    # K2q on the plant field: modes 1 and 2 on the primaries, mode 3 on
    # walks from their hits toward the sun and the hit's hemisphere
    pprim = head(plant, *pixel_grid_rays(plant_cam, side, side))
    cases[f"K2q mode 1 plant {side}^2 primaries"] = (alpha, pprim + (plant_tables,))
    cases[f"K2q mode 2 plant {side}^2 primaries"] = (record, pprim + (plant_tables,))
    pres = tv.traverse_alpha(*pprim, plant_tables)
    hn = resolve_hit(plant, pprim[4], pprim[5], pres)[2]
    hp = torch.where(pres.hit[:, None], pprim[4] + pprim[5] * pres.t[:, None], pprim[4])
    su = torch.from_numpy(np.random.default_rng(12).random((side * side, 5), dtype=np.float32)).to(dev)
    sun = random_sun_direction(plant.sun, su[:, 0], su[:, 1]).contiguous()
    rnd = torch.from_numpy(np.random.default_rng(13).standard_normal((side * side, 3)).astype(np.float32)).to(dev)
    rnd = rnd / rnd.norm(dim=-1, keepdim=True)
    rnd = torch.where(((rnd * hn).sum(-1) < 0)[:, None], -rnd, rnd).contiguous()
    for label, sd, strict, record_t in (("sun", sun, True, False), ("hemisphere", rnd, False, True)):
        front = (sd * hn).sum(-1) > 0.0
        so = (torch.where(front[:, None], hp, hp - OFFSET * hn) + sd * OFFSET).contiguous()
        cases[f"K2q mode 3 plant {label} walk"] = (shadow, head(plant, so, sd) + (
            plant_tables, air, strict, record_t, 1024.0, pres.hit & front))
    return cases


def _equal(k, r) -> bool:
    """Every field of two HitResults bit for bit (NaN where both are NaN)."""
    fields = ("hit", "t", "face_id", "uv", "leaf_value", "voxel_pos", "voxel_size", "fetches")
    return all(bool(((a == b) | (a.isnan() & b.isnan()) if a.is_floating_point() else (a == b)).all())
               for a, b in ((getattr(k, f), getattr(r, f)) for f in fields))


def _time_checkout(world=None) -> dict:
    """P1, P2, the traversal, K4 and the light lines of the package on
    ``sys.path`` (see the module's text)."""
    import octree_pathtracing_tpu_torch as port
    from octree_pathtracing_tpu_torch.ops import gather
    from octree_pathtracing_tpu_torch.ops.random import philox_uniforms, philox_uniforms_reference

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator().manual_seed(3)
    probe = torch.randint(-2**31, 2**31 - 1, (1 << 17, 8), generator=g, dtype=torch.int32).to(dev)
    probe_idx = torch.randint(0, 1 << 17, (4096,), generator=g, dtype=torch.int32).to(dev)
    grid_idx = torch.randint(0, 128, (4096, 8), generator=g, dtype=torch.int32).to(dev)
    grid_w = torch.rand((4096, 8), generator=g).to(dev)
    cells = torch.randint(0, 4096, (65536,), generator=g, dtype=torch.int32).to(dev)
    pair = getattr(gather, "row_gather_pair", None)
    if pair is None:  # a checkout from before the pair: the pick's two launches
        def pair(a, b, i):
            return gather.row_gather(a, i), gather.row_gather(b, i)

    def bits(x):
        return x.view(torch.int32)

    for table, idx in ((probe, probe_idx), (probe, probe_idx.long()), (grid_idx, cells), (grid_w, cells)):
        if not torch.equal(bits(gather.row_gather(table, idx)), bits(gather.row_gather_reference(table, idx))):
            raise AssertionError("P1 disagrees with its twin")
    if not all(torch.equal(bits(k), bits(gather.row_gather_reference(t, cells)))
               for k, t in zip(pair(grid_idx, grid_w, cells), (grid_idx, grid_w))):
        raise AssertionError("the pair disagrees with its twin")
    n_block = 65536 * 5 * 21
    if not torch.equal(philox_uniforms(12345, 7, n_block, dev), philox_uniforms_reference(12345, 7, n_block, dev)):
        raise AssertionError("P2 disagrees with its twin")

    probe_long, cells_long = probe_idx.long(), cells.long()
    out = {"package": os.path.dirname(port.__file__), "card": card_line(),
           "pair_launches": 1 if hasattr(gather, "row_gather_pair") else 2}
    cases = {
        "P1 probe int32 idx": lambda: gather.row_gather(probe, probe_idx),
        "P1 probe int64 idx": lambda: gather.row_gather(probe, probe_long),
        "index_select probe": lambda: torch.index_select(probe, 0, probe_long),
        "P1 grid_idx": lambda: gather.row_gather(grid_idx, cells),
        "P1 grid_w": lambda: gather.row_gather(grid_w, cells),
        "index_select grid_w": lambda: torch.index_select(grid_w, 0, cells_long),
        "P1 pick (grid_idx + grid_w)": lambda: pair(grid_idx, grid_w, cells),
        "2 x index_select pick": lambda: (torch.index_select(grid_idx, 0, cells_long),
                                          torch.index_select(grid_w, 0, cells_long)),
        "P2 (65536, 5, 21)": lambda: philox_uniforms(12345, 7, n_block, dev),
        "torch.rand (65536, 5, 21)": lambda: torch.rand((65536, 5, 21), device=dev),
    }
    for name, fn in cases.items():
        out[name] = both(fn)

    cache_dir = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "build",
                                              "scenes"))
    out.update(_shade_cases(dev, cache_dir))
    out.update(_nee_bounce_cases(dev, cache_dir))
    if _has_compact():
        out.update(_compact_cases(dev, cache_dir))
    out.update(_light_lines(dev, cache_dir, world))
    out.update(_time_traversals(_traversal_cases(dev, cache_dir)))
    return out


def _has_compact() -> bool:
    """Whether the checkout on ``sys.path`` has K5's kernel."""
    import importlib.util

    return importlib.util.find_spec("octree_pathtracing_tpu_torch.ops.compact") is not None


def _time_k5(dev, cache_dir) -> dict:
    """K5's rows and the headline forward frame's CUDA graph replay alone
    (``--k5``: an A/B of K5's design)."""
    from octree_pathtracing_tpu_torch.models import minecraft_chunk_scene, pixel_grid_rays
    from octree_pathtracing_tpu_torch.render import pathtracer

    scene, cam = minecraft_chunk_scene(depth=9, cache_dir=cache_dir)
    scene, cam = scene.to(dev), cam.to(dev)
    o, d = pixel_grid_rays(cam, 256, 256)
    out = _compact_cases(dev, cache_dir)
    out["headline frame forward, CUDA graph replay"] = _graph_frame_case(
        scene, o, d, pathtracer.draw_uniforms(1, 0, 256 * 256, 5, dev))
    return out


def _time_bounces(dev, cache_dir) -> dict:
    """The bounce loop's rows alone (``--bounces``): K1, K4 and the
    next-event kernels on each bounce of one frame, the headline frames, and
    K5's rows where the checkout has it."""
    from octree_pathtracing_tpu_torch.models import minecraft_chunk_scene

    terrain, cam = minecraft_chunk_scene(depth=9, cache_dir=cache_dir)
    out = _time_traversals(_k1_bounce_cases(dev, terrain.to(dev), cam.to(dev)))
    out.update(_shade_cases(dev, cache_dir))
    out.update(_nee_bounce_cases(dev, cache_dir))
    if _has_compact():
        out.update(_compact_cases(dev, cache_dir))
    return out


def _time_k8(dev, cache_dir) -> dict:
    """``--k8``: kernel K8 on the depth-9 plant field's quad soup (its BVH
    built once into ``cache_dir``, ``plant_bvh_file``) against the 256x256
    plant primaries, without and with the octree hit's t as ``t_init``:
    hit, t and payload bit for bit against the twin, then by call and on
    the device, with the rows the twin's walk reads (a row on every pop, two
    on every expansion) and the fewest the same walk needs (the root's, two
    on every expansion)."""
    from octree_pathtracing_tpu_torch.models import pixel_grid_rays
    from octree_pathtracing_tpu_torch.ops import bvh as k8
    from octree_pathtracing_tpu_torch.ops.geometry import make_quads
    from octree_pathtracing_tpu_torch.render import pathtracer

    path = os.path.join(cache_dir, "plant_bvh_d9.npz")
    info, scene, cam = plant_bvh_file(path, 9)
    with np.load(path) as z:
        bvh = k8.BVH.from_arrays(z["node_min"], z["node_max"], z["left"], z["right"], z["prim_order"]).to(dev)
        quads = make_quads(z["o"], z["u"], z["v"], z["mat"]).to(dev)
    scene, cam = scene.to(dev), cam.to(dev)
    o, d = (x.contiguous() for x in pixel_grid_rays(cam, 256, 256))
    res = pathtracer._trace(scene, o, d)
    out = {}
    for label, t_init in (("", None), (", t_init the octree's hit", torch.where(res.hit, res.t, float("inf")))):
        stats = {}
        k = k8.bvh_intersect_quads(bvh, quads, o, d, t_init)
        r = k8.bvh_intersect_reference(bvh, o, d, k8.quad_prim_fn(quads), t_init, stats=stats)
        if not all(torch.equal(a, b) for a, b in zip(k, r)):
            raise AssertionError(f"K8 disagrees with its twin on the plant primaries{label}")
        row = both(lambda t_init=t_init: k8.bvh_intersect_quads(bvh, quads, o, d, t_init))
        b = o.shape[0]
        row.update(lanes=b, quads=info["quads"], hits=int(k[0].sum()), tree_depth=k8.tree_depth(bvh),
                   twin_rows=stats["nodes"] + 2 * stats["interior"], fewest_rows=b + 2 * stats["interior"],
                   quads_tested=stats["prims"])
        out[f"K8 plant primaries{label}"] = row
    return out


def _time_train(dev, cache_dir) -> dict:
    """``--train``: chip_smoke.py's phase-7 commands, ``cli train`` on the
    depth-9 chunk and cutout scenes (8 views at 512x512, 3 steps), each
    with its step seconds and the peak device memory of the command."""
    import tempfile

    from octree_pathtracing_tpu_torch import cli

    out = {}
    for scene in ("chunk", "cutout"):
        with tempfile.TemporaryDirectory() as d:
            argv = ["train", "--scene", scene, "--depth", "9", "--views", "8", "--width", "512", "--height", "512",
                    "--steps", "3", "--device", "cuda", "-o", os.path.join(d, "params.npz")]
            parsed = cli.build_parser().parse_args(argv)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            res = parsed.fn(parsed)
            torch.cuda.synchronize()
            out[f"cli train {scene} 8 views 512x512"] = {"peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                                                         "step_s": list(res.step_seconds)}
    return out


MODES = ("--k4", "--bounces", "--k5", "--nee", "--train", "--prims", "--k8")


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args[:1] == ["--one"]:  # a child: time the checkout at args[1]
        sys.path.insert(0, os.path.abspath(args[1]))
        if not torch.cuda.is_available():
            print("timing: no CUDA device", file=sys.stderr)
            return 1
        if args[-1:] and args[-1] in MODES:
            dev = torch.device("cuda", torch.cuda.current_device())
            cache_dir = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                                                      "build", "scenes"))
            import octree_pathtracing_tpu_torch as port

            world = args[3] if args[2:3] == ["--world"] else None
            if args[-1] == "--nee":
                rows = _time_nee(dev, cache_dir, world)
            else:
                rows = {"--k4": _k4_cases, "--bounces": _time_bounces, "--k5": _time_k5,
                        "--train": _time_train, "--k8": _time_k8,
                        "--prims": lambda *a: _prim_cases(*a, frames=True)}[args[-1]](dev, cache_dir)
            result = {"package": os.path.dirname(port.__file__), "card": card_line(), **rows}
        else:
            result = _time_checkout(args[3] if args[2:3] == ["--world"] else None)
        print("RESULT " + json.dumps(result), flush=True)
        return 0
    out_file = world = mode = None
    while args[:1] in (["--out"], ["--world"]) or (args[:1] and args[0] in MODES):
        if args[0] in MODES:
            mode, args = args[0], args[1:]
            continue
        if args[0] == "--out":
            out_file = args[1]
        else:
            world = os.path.abspath(args[1])
        args = args[2:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in args:
        # one hash seed for every checkout: the block palette seeds its textures
        # with hash(), salted per process (ROADMAP §3), and the frames compare
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root]
                              + (["--world", world] if world else []) + ([mode] if mode else []),
                              capture_output=True, text=True, timeout=900,
                              env=dict(os.environ, PYTHONHASHSEED="0"))
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"timing {root} failed (exit {proc.returncode})")
        runs.append(dict(root=root, **json.loads(lines[-1][len("RESULT "):])))
        print(f"{root}: {runs[-1]['package']} [{runs[-1]['card']}]", flush=True)
    names = list(dict.fromkeys(k for r in runs for k, v in r.items() if isinstance(v, dict)))
    for name in names:
        have = [r for r in runs if name in r]
        if "host_ms" in have[0][name]:  # a frame: host ms and its device launches
            print(f"{name}: " + " | ".join(
                f"{r['root']}: host ms {r[name]['host_ms']!r} {[round(t, 3) for t in r[name]['host_ms_runs']]}, "
                f"kernels {r[name]['kernels']} memsets {r[name]['memsets']} memcpys {r[name]['memcpys']}"
                + (f" (through the next-event plain version: kernels {r[name]['plain_nee']['kernels']} memsets "
                   f"{r[name]['plain_nee']['memsets']} memcpys {r[name]['plain_nee']['memcpys']})"
                   if "plain_nee" in r[name] else "")
                for r in have)
                + ("" if "radiance_sha256" not in have[0][name] else
                   f" || radiance bit-equal in every checkout: "
                   f"{len({r[name]['radiance_sha256'] for r in have}) == 1}")
                + "".join(f" || {r['root']}: graph replay "
                          + (f"{r[name]['graph']['replay_ms']!r} ms, bit-equal {r[name]['graph']['bit_equal']}"
                             if "replay_ms" in r[name]["graph"] else r[name]["graph"]["error"])
                          for r in have if "graph" in r[name]), flush=True)
            continue
        if "peak_gib" in have[0][name]:  # a training command
            print(f"{name}: " + " | ".join(f"{r['root']}: peak {r[name]['peak_gib']!r} GiB, step s "
                                           f"{[round(t, 3) for t in r[name]['step_s']]}" for r in have), flush=True)
            continue
        if "replay_ms" in have[0][name]:  # a captured frame's replays
            print(f"{name}: " + " | ".join(
                f"{r['root']}: median {r[name]['replay_ms']!r} ms {[round(t, 4) for t in r[name]['replay_ms_runs']]}, "
                f"bit-equal to the eager frame {r[name]['bit_equal']}" for r in have), flush=True)
            continue
        cells = " | ".join(f"{r['root']}: call {r[name]['call_ms']!r} device {r[name]['device_ms']!r}"
                           + ("" if r[name]["device_by"] == "graph" else f" ({r[name]['device_by']})")
                           + (f" fwd+bwd call {r[name]['fwd_bwd_call_ms']!r}" if "fwd_bwd_call_ms" in r[name] else "")
                           + (f" plain {r[name]['plain_ms']!r}" if "plain_ms" in r[name] else "")
                           + (f" [lanes {r[name]['lanes']}, live {r[name]['live']}"
                              + (f", {r[name]['faces']} faces, {r[name]['cast']} cast" if "cast" in r[name] else "")
                              + "]" if "live" in r[name] else "")
                           for r in have)
        extra = have[0][name]
        if "lanes" in extra and "live" not in extra:
            cells += f" || lanes {extra['lanes']}"
        if "fetch_max" in extra:  # the same rays and fetches in every checkout
            cells += (f" || fetches max {extra['fetch_max']} p50 {extra['fetch_p50']!r} "
                      f"p99 {extra['fetch_p99']!r}")
        if "twin_rows" in extra:  # K8: the same rays and walk in every checkout
            cells += (f" || {extra['quads']} quads, depth {extra['tree_depth']}, hits {extra['hits']}; node rows "
                      f"the twin's walk reads {extra['twin_rows']}, the fewest {extra['fewest_rows']}; quads "
                      f"tested {extra['quads_tested']}")
        print(f"{name}: {cells}", flush=True)
    if out_file:
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        with open(out_file, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.path.pop(0)  # this file's directory: the checkout to time comes first
    sys.exit(main())
