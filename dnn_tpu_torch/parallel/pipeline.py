"""Pipeline-parallel runtimes (port of dnn_tpu/parallel/pipeline.py:58-915
without the training schedule).

1. `RelayExecutor` runs stages in order, stage i on device i mod n, with
   each stage's parameters placed on its device once, at construction.
   A hop hands the activation to the next stage's device: on one card it
   is the same tensor, with no host copy. `measure_hop_latency` times
   each hop by JAX's two-point slope.

2. `spmd_pipeline` (heterogeneous stages), `spmd_pipeline_stacked`
   (uniform block stacks) and `spmd_pipeline_interleaved` (virtual
   stages) run one process over a stage mesh (parallel/mesh.py): one
   CUDA stream per stage, the GPipe clock — at tick t stage d runs
   microbatch t - d, for M + S - 1 ticks; the interleaved order takes
   V*M + S - 1 — and the hop from stage d to d + 1 is a device copy
   ordered after stage d's work by a CUDA event (on one card, the same
   tensor handed to the next stage's stream). The output is the last
   stage's, so no psum is needed, and an idle stage computes nothing.
   JAX's padded flat hop buffer, its bitcast carrier (`_buffer_dtype`)
   and the `lax.switch` exist for `ppermute` and are not ported; the
   results keep the relay's dtypes and shapes. Each stage's work runs
   under a `pipeline.stage{i}` range (torch.profiler.record_function),
   as JAX names its stages with `jax.named_scope`, so `/profilez` and
   `timeline.analyze` see each stage.

`param_placement` resolves as JAX's does: "stage" packs the stages'
float leaves into one row a stage (`pack_stage_params`) and each stage
device holds only its row; "replicated" places every stage's tree on
every stage device; "auto" packs unless a leaf requires grad (JAX keeps
replicated semantics under a trace: a pack would cut the autograd graph
here). The 1F1B training schedule, `data_axis` (dp x pp) and
`param_specs` (tp x pp) need torch.distributed: ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from dnn_tpu_torch.parallel.mesh import STAGE_AXIS, as_mesh


def split_microbatches(x, num_microbatches: int):
    """(B, ...) -> (M, B // M, ...)."""
    b = x.shape[0]
    if b % num_microbatches != 0:
        raise ValueError(
            f"batch {b} not divisible by microbatches {num_microbatches}")
    return x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])


def merge_microbatches(y):
    return y.reshape(y.shape[0] * y.shape[1], *y.shape[2:])


def place(tree, device):
    """A parameter tree of numpy arrays or tensors -> the same tree of
    tensors on `device` (dtypes kept; numpy arrays are copied, since a
    loaded array may be a read-only view)."""
    if isinstance(tree, dict):
        return {k: place(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.tensor(np.asarray(tree)).to(device)


def sync(device):
    """Wait for `device`'s queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class RelayExecutor:
    """Sequential stage relay across explicit devices. `record_timings`
    runs keep each stage's compute seconds in `last_stage_times`, timed
    between device synchronizations (and observed as
    `relay.stage_compute_seconds{stage,transport}`)."""

    #: how a hop moves the activation: a same-process device hand-over
    transport = "device"

    def __init__(self, stage_fns: Sequence[Callable],
                 stage_params: Sequence[Any], devices: Sequence):
        if len(stage_fns) != len(stage_params):
            raise ValueError("one params tree per stage required")
        devices = [torch.device(d) for d in devices]
        self.devices = [devices[i % len(devices)]
                        for i in range(len(stage_fns))]
        self.stage_params = [place(p, d)
                             for p, d in zip(stage_params, self.devices)]
        self.stage_fns = list(stage_fns)
        self.last_stage_times: Optional[List[float]] = None

    @torch.no_grad()
    def __call__(self, x, *, record_timings: bool = False):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        times = []
        for fn, params, dev in zip(self.stage_fns, self.stage_params,
                                   self.devices):
            x = x.to(dev)
            if record_timings:
                sync(dev)
                t0 = time.perf_counter()
            x = fn(params, x)
            if record_timings:
                sync(dev)
                times.append(time.perf_counter() - t0)
        self.last_stage_times = times if record_timings else None
        if record_timings:
            self._observe("relay.stage_compute_seconds", "stage",
                          enumerate(times))
        return x

    def _observe(self, name, label, values):
        from dnn_tpu_torch import obs
        from dnn_tpu_torch.utils.metrics import labeled

        m = obs.metrics()
        if m is not None:
            for i, v in values:
                m.observe(labeled(name, **{label: i},
                                  transport=self.transport), v)

    @torch.no_grad()
    def measure_hop_latency(self, x, *, n1: int = 2,
                            n2: int = 8) -> List[float]:
        """One-way transfer time of each inter-stage hop (JAX :213): the
        activation entering stage i ping-pongs between the two stage
        devices n times back to back, one sync at the end, and the
        two-point slope (t(n2) - t(n1)) / (n2 - n1), halved, cancels the
        sync's constant cost. One entry per hop (stage i-1 -> stage i),
        clamped at 0; also observed as `relay.hop_seconds{hop,transport}`.
        Two stages on one card hand the tensor over without a copy, so
        their hop measures ~0."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        acts = []
        for fn, params, dev in zip(self.stage_fns, self.stage_params,
                                   self.devices):
            acts.append(x)
            x = fn(params, x.to(dev))
        sync(x.device)
        hops = []
        for i in range(1, len(self.devices)):
            a, b = self.devices[i - 1], self.devices[i]
            act = acts[i].to(a)
            sync(a)

            def run(n):
                y = act
                t0 = time.perf_counter()
                for _ in range(n):
                    y = y.to(b).to(a)
                sync(a)
                sync(b)
                return time.perf_counter() - t0

            run(1)  # warm-up
            hops.append(max(0.0, (run(n2) - run(n1)) / (n2 - n1) / 2.0))
        self._observe("relay.hop_seconds", "hop", enumerate(hops, start=1))
        return hops


# ----------------------------------------------------------------------
# the stage clock: one stream a stage, event-ordered hops
# ----------------------------------------------------------------------

class _StageClock:
    """The streams of one pipeline call. Each stage's work runs on its
    own stream (the CPU has none: work runs in dispatch order); every
    stream first waits for the caller's stream, so inputs and
    parameters made before the call are ready."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.streams = []
        for d in self.devices:
            if d.type == "cuda":
                s = torch.cuda.Stream(device=d)
                s.wait_stream(torch.cuda.current_stream(d))
                self.streams.append(s)
            else:
                self.streams.append(None)

    def enter(self, x, d: int = 0):
        """A host or caller-stream tensor into stage d, copied on stage
        d's stream (a copy from pageable host memory may still be in
        flight when `.to` returns: only the stream that issued it is
        ordered after it)."""
        s = self.streams[d]
        if s is None:
            return x.to(self.devices[d])
        with torch.cuda.stream(s):
            y = x.to(self.devices[d])
        y.record_stream(s)
        return y

    def run(self, d: int, fn, x):
        """fn(x) on stage d's stream, under `pipeline.stage{d}`."""
        s = self.streams[d]
        with record_function(f"pipeline.stage{d}"):
            if s is None:
                return fn(x)
            with torch.cuda.stream(s):
                return fn(x)

    def hop(self, y, src: int, dst: int):
        """Stage src's output onto stage dst's device, ordered after
        stage src's work by an event. The caching allocator is told
        that dst's stream reads y (record_stream), so y's memory is not
        handed out again while that stream may still read it."""
        s_src, s_dst = self.streams[src], self.streams[dst]
        if s_src is None and s_dst is None:
            return y.to(self.devices[dst])
        ev = torch.cuda.Event()
        ev.record(s_src)
        src_dev, dst_dev = self.devices[src], self.devices[dst]
        with torch.cuda.stream(s_dst):
            s_dst.wait_event(ev)
            if src_dev != dst_dev:
                # a copy between cards runs on the source card's current
                # stream: order it after stage src's work too
                cur = torch.cuda.current_stream(src_dev)
                cur.wait_event(ev)
                y.record_stream(cur)
            out = y.to(dst_dev, non_blocking=True)
        y.record_stream(s_dst)
        return out

    def finish(self, outs, d: int):
        """The last stage's outputs, handed back to the caller's stream
        on stage d's device."""
        s = self.streams[d]
        if s is not None:
            cur = torch.cuda.current_stream(self.devices[d])
            cur.wait_stream(s)
            for o in outs:
                o.record_stream(cur)
        return outs


def _gpipe(clock: _StageClock, steps: Sequence[Callable], inputs):
    """The GPipe clock: at tick t stage d runs microbatch t - d, for
    M + S - 1 ticks; a stage's output hops to stage d + 1 for the next
    tick. Returns the last stage's outputs in microbatch order."""
    n_stages, m_count = len(steps), len(inputs)
    inbox, outs = {}, [None] * m_count
    for t in range(m_count + n_stages - 1):
        for d in range(n_stages):
            m = t - d
            if not 0 <= m < m_count:
                continue
            x = clock.enter(inputs[m]) if d == 0 else inbox.pop((d, m))
            y = clock.run(d, steps[d], x)
            if d + 1 < n_stages:
                inbox[(d + 1, m)] = clock.hop(y, d, d + 1)
            else:
                outs[m] = y
    return clock.finish(outs, n_stages - 1)


def run_stages(steps: Sequence[Callable], x, *, mesh,
               num_microbatches: int = 1):
    """The GPipe clock over per-stage callables on the stage mesh:
    steps[d](h) runs on mesh device d's stream; x (B, ...) splits into
    `num_microbatches`; returns the last stage's outputs, merged. The
    stages may change shapes and dtypes (the engine's stacked GPT path
    embeds on stage 0 and runs the head on the last)."""
    mesh = as_mesh(mesh)
    if len(steps) != len(mesh):
        raise ValueError(f"{len(steps)} stages for a mesh of {len(mesh)}")
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    inputs = list(split_microbatches(x, num_microbatches).unbind(0))
    with torch.no_grad():
        outs = _gpipe(_StageClock(mesh.devices), steps, inputs)
    return torch.cat(outs, dim=0)


# ----------------------------------------------------------------------
# heterogeneous stages: spmd_pipeline
# ----------------------------------------------------------------------

def _requires_grad(tree) -> bool:
    return any(isinstance(l, torch.Tensor) and l.requires_grad
               for l in _leaves(tree))


def pack_stage_params(stage_params):
    """Heterogeneous per-stage parameter trees -> one (S, W) numpy array
    on the host (each stage's leaves flattened, concatenated and
    zero-padded to the widest stage) plus each stage's unpack metadata
    (JAX :316). Row d goes to stage d's device, so each device holds
    only its own stage's weights. One float dtype keeps its type; mixed
    float dtypes ride an f32 carrier (a mix with f64 is refused rather
    than truncated); integer leaves are refused (keep such models on
    param_placement="replicated")."""
    per_stage, dtypes = [], set()
    for p in stage_params:
        keys, arrs = [], []
        for path, leaf in _flatten(p):
            arr = (leaf.detach().cpu().numpy()
                   if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
            if not np.issubdtype(arr.dtype, np.floating):
                raise ValueError(
                    f"pack_stage_params supports float leaves only, got "
                    f"{arr.dtype}; use spmd_pipeline(..., "
                    f"param_placement='replicated') for non-float params")
            keys.append(path)
            arrs.append(arr)
            dtypes.add(arr.dtype)
        per_stage.append((keys, arrs))
    if len(dtypes) == 1:
        carrier = dtypes.pop()
    else:
        carrier = np.dtype(np.float32)
        wide = [d for d in dtypes if d.itemsize > 4]
        if wide:
            raise ValueError(
                f"pack_stage_params: mixed param dtypes "
                f"{sorted(map(str, dtypes))} would silently truncate "
                f"{sorted(map(str, wide))} through the f32 carrier; cast "
                f"params to one dtype or use spmd_pipeline(..., "
                f"param_placement='replicated')")
    flats, metas = [], []
    for keys, arrs in per_stage:
        vecs = [a.astype(carrier).reshape(-1) for a in arrs]
        flats.append(np.concatenate(vecs) if vecs
                     else np.zeros((0,), carrier))
        metas.append([(k, a.shape, a.dtype) for k, a in zip(keys, arrs)])
    width = max((f.shape[0] for f in flats), default=1) or 1
    packed = np.stack([np.pad(f, (0, width - f.shape[0])) for f in flats])
    return packed, metas


def _flatten(tree, prefix=()):
    """(path tuple, leaf) pairs of a dict tree in sorted key order (JAX's
    flatten order, so a packed row is laid out as JAX's)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (k,))
    else:
        yield prefix, tree


_TORCH_DTYPES = {np.dtype(np.float16): torch.float16,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def _unpack_stage(vec, meta):
    """A packed row (W,) -> the stage's parameter tree: views into the
    row where the leaf keeps the carrier's type, casts otherwise."""
    tree: dict = {}
    off = 0
    for path, shape, dtype in meta:
        n = int(np.prod(shape)) if shape else 1
        leaf = vec[off:off + n].reshape(shape)
        want = _TORCH_DTYPES.get(np.dtype(dtype), leaf.dtype)
        if leaf.dtype != want:
            leaf = leaf.to(want)
        off += n
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if path:
            node[path[-1]] = leaf
        else:
            tree = leaf
    return tree


def place_packed(packed, mesh):
    """pack_stage_params' (S, W) array -> one row tensor on each stage's
    device: the `packed=` placement spmd_pipeline takes (rows, metas)."""
    arr, metas = packed
    devices = as_mesh(mesh).devices
    if len(arr) != len(devices):
        raise ValueError(f"{len(arr)} packed rows for {len(devices)} stages")
    rows = [torch.from_numpy(np.ascontiguousarray(arr[d])).to(dev)
            for d, dev in enumerate(devices)]
    return rows, metas


def place_replicated(stage_params, mesh):
    """Every stage's tree on every distinct stage device: {device: [tree
    of stage 0, ...]} (param_placement="replicated")."""
    out = {}
    for dev in as_mesh(mesh).devices:
        if dev not in out:
            out[dev] = [place(p, dev) for p in stage_params]
    return out


def spmd_pipeline(stage_fns: Sequence[Callable], stage_params: Sequence[Any],
                  x, *, mesh, num_microbatches: int = 1,
                  axis_name: str = STAGE_AXIS, param_placement: str = "auto",
                  packed=None, replicated=None):
    """Heterogeneous-stage pipeline over the stage mesh: stage d applies
    stage_fns[d] on mesh device d to microbatch t - d at tick t; returns
    the last stage's outputs with the microbatches merged, in its dtype.

    `param_placement` (JAX :471): "stage" gives stage d's device only
    its packed row (pack_stage_params; pass `packed=(rows, metas)` from
    place_packed to pack once at load), "replicated" every stage's tree
    on every stage device (`replicated=` from place_replicated places it
    once), "auto" packs unless a leaf requires grad. "stage" over
    leaves that require grad, without `packed=`, raises as JAX's does
    over traced leaves."""
    mesh = as_mesh(mesh)
    num_stages = len(stage_fns)
    if mesh.shape[axis_name] != num_stages:
        raise ValueError(
            f"mesh axis '{axis_name}' has size {mesh.shape[axis_name]}, "
            f"need {num_stages} (one device per stage)")
    if param_placement not in ("auto", "stage", "replicated"):
        raise ValueError(f"param_placement must be auto|stage|replicated, "
                         f"got {param_placement!r}")
    sharded = param_placement in ("auto", "stage")
    if sharded and packed is None and _requires_grad(stage_params):
        if param_placement == "stage":
            raise ValueError(
                "param_placement='stage' with stage_params that require "
                "grad: packing would cut the autograd graph. Pack once "
                "outside and pass packed=(rows, metas) (what the engine "
                "does), or use param_placement='replicated'/'auto'.")
        sharded = False
    devices = mesh.devices
    if sharded:
        rows, metas = packed if packed is not None else place_packed(
            pack_stage_params(stage_params), mesh)
        params = [_unpack_stage(rows[d], metas[d]) for d in range(num_stages)]
    else:
        if replicated is None:
            replicated = place_replicated(stage_params, mesh)
        params = [replicated[devices[d]][d] for d in range(num_stages)]
    return run_stages([lambda h, _fn=fn, _p=p: _fn(_p, h)
                       for fn, p in zip(stage_fns, params)], x, mesh=mesh,
                      num_microbatches=num_microbatches)


# ----------------------------------------------------------------------
# uniform stacks: spmd_pipeline_stacked, spmd_pipeline_interleaved
# ----------------------------------------------------------------------

def stacked_param_placement(stacked_params, *, axis_name: str = STAGE_AXIS):
    """The stacked pipeline's placement contract (JAX :876): every leaf's
    leading axis is the stage axis, so each stage device holds exactly
    its own 1/S slice. Returns the tree of axis names, one per leaf."""
    return _tree_map(lambda _: axis_name, stacked_params)


def _as_tensor(leaf):
    return leaf if isinstance(leaf, torch.Tensor) \
        else torch.tensor(np.asarray(leaf))


def stage_slices(stacked_params, mesh):
    """A tree of (S, ...) leaves -> S per-stage trees, slice d placed on
    mesh device d."""
    mesh = as_mesh(mesh)
    leading = {int(_as_tensor(l).shape[0]) for l in _leaves(stacked_params)}
    if leading != {len(mesh)}:
        raise ValueError(f"stacked_params leading axis {leading} != the "
                         f"stage count {len(mesh)}")
    return [_tree_map(lambda l, _d=d, _dev=dev: _as_tensor(l)[_d].to(_dev),
                      stacked_params)
            for d, dev in enumerate(mesh.devices)]


def _refuse_item_10(what: str):
    raise NotImplementedError(
        f"{what} needs torch.distributed and is not ported to "
        "dnn_tpu_torch yet (ROADMAP Queue 1 item 10)")


def spmd_pipeline_stacked(block_fn: Callable, stacked_params, x, *, mesh,
                          num_microbatches: int = 1,
                          axis_name: str = STAGE_AXIS,
                          data_axis: Optional[str] = None,
                          param_specs=None):
    """Homogeneous-stage pipeline (JAX :891): `stacked_params` has a
    leading stage axis (slice d goes to stage d's device), and
    `block_fn(params_slice, x) -> y` keeps x's shape. Returns the last stage's output, microbatches
    merged, in x's dtype. `data_axis` and `param_specs` are Queue 1
    item 10's."""
    if data_axis is not None:
        _refuse_item_10("spmd_pipeline_stacked's data_axis (dp x pp)")
    if param_specs is not None:
        _refuse_item_10("spmd_pipeline_stacked's param_specs (tp x pp)")
    mesh = as_mesh(mesh)
    if mesh.shape[axis_name] < 1:
        raise ValueError("empty stage mesh")
    params = stage_slices(stacked_params, mesh)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    dtype = x.dtype
    return run_stages([lambda h, _p=p: block_fn(_p, h).to(dtype)
                       for p in params], x, mesh=mesh,
                      num_microbatches=num_microbatches)


def interleaved_schedule_steps(num_stages: int, virtual_stages: int,
                               num_microbatches: int) -> int:
    """Sub-step count of the interleaved schedule: V*M + S - 1 (JAX
    :744)."""
    return virtual_stages * num_microbatches + num_stages - 1


def spmd_pipeline_interleaved(block_fn: Callable, stacked_params, x, *,
                              mesh, num_microbatches: int,
                              virtual_stages: int,
                              axis_name: str = STAGE_AXIS):
    """Interleaved (virtual-stage) pipeline over stacked chunks (JAX
    :753). Chunk j of V*S (leading axis, layer order) lives on device
    j % S; sub-step t on device d serves, with k = t - d,
    g = k // (V*S), c = (k % (V*S)) // S and m = g*S + k % S, chunk
    c*S + d of microbatch m, and hands its output to device (d + 1) % S
    for sub-step t + 1; V*M + S - 1 sub-steps in all. `num_microbatches`
    must divide by the stage count."""
    mesh = as_mesh(mesh)
    num_stages = mesh.shape[axis_name]
    v = virtual_stages
    if v < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {v}")
    leading = {int(_as_tensor(l).shape[0]) for l in _leaves(stacked_params)}
    if leading != {v * num_stages}:
        raise ValueError(
            f"stacked_params leading axis {leading} != virtual_stages * "
            f"num_stages = {v * num_stages}")
    if num_microbatches % num_stages:
        raise ValueError(
            f"num_microbatches {num_microbatches} must divide by the stage "
            f"count {num_stages} for the interleaved ordering")
    m_count = num_microbatches
    devices = mesh.devices
    # device d holds chunks {c*S + d : c < V}
    chunks = [[_tree_map(lambda l, _j=c * num_stages + d, _dev=dev:
                         _as_tensor(l)[_j].to(_dev), stacked_params)
               for c in range(v)] for d, dev in enumerate(devices)]
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    inputs = list(split_microbatches(x, m_count).unbind(0))
    dtype = x.dtype
    clock = _StageClock(devices)
    inbox, outs = {}, [None] * m_count
    with torch.no_grad():
        for t in range(interleaved_schedule_steps(num_stages, v, m_count)):
            for d in range(num_stages):
                k = t - d
                if not 0 <= k < v * m_count:
                    continue
                j = k % (v * num_stages)
                c, m = j // num_stages, (k // (v * num_stages)) * num_stages \
                    + j % num_stages
                x_in = (clock.enter(inputs[m], d) if d == 0 and c == 0
                        else inbox.pop((d, t)))
                y = clock.run(d, lambda h, _p=chunks[d][c]:
                              block_fn(_p, h).to(dtype), x_in)
                if d == num_stages - 1 and c == v - 1:
                    outs[m] = y
                else:
                    nxt = (d + 1) % num_stages
                    inbox[(nxt, t + 1)] = clock.hop(y, d, nxt)
        clock.finish(outs, num_stages - 1)
    return torch.cat(outs, dim=0)
