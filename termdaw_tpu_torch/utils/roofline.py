"""Roofline accounting of the port's renders.

Port of termdaw_tpu/utils/roofline.py. For each config of a render it
answers how many flops and bytes one window program costs, what share of
the card's peaks the measured render reaches, and which wall is closer.
The reference read XLA's cost analysis of its compiled window programs; a
captured CUDA graph has none, so the port counts its own program instead:
`count_work()` runs a stretch of tensor code under a dispatch mode that
sees every aten op, and `CompiledGraph.window_cost` runs one window's
eager program under it. The streamed render resample runs outside the
window programs and is added analytically, as in the reference.

Counting rules, per aten op:

* flops: 2*M*N*K for the matrix products; the input's element count for
  reductions and cumulative ops; 0 for data movement (views, copies,
  concatenation, index/gather/scatter, fills, allocation); otherwise one
  per output element;
* "bytes accessed" (the reference's logical count): the bytes of each
  tensor input plus each output; a view counts 0, and a gather counts the
  elements it gathers, not its whole source;
* storages, for the physical estimate (`_mem`): `arg_bytes`, each storage
  that existed before the count and that it reads, once; `out_bytes`, each
  such storage it writes, plus the returned audio; `temp_bytes`, each
  storage allocated inside the count and not returned, once an
  allocation.

A hand-written kernel's launch goes through ctypes, which no dispatch mode
sees, and on the CPU its plain version would be counted op by op; so each
kernel wrapper is decorated with `counted(work)`: under a count it runs
its body uncounted and adds `work(*args)`, its (flops, bytes), instead.
The count is then the same on the CPU as on the card. With no count
active the decorator costs one module-level check.

Caveats, as in the reference: the logical count is an upper estimate of
demand, not a DMA measurement; the physical estimate (args read once,
outputs written once, temps written and read once) may over- or
under-count, and an estimate above the card's bus peak is never printed
as a share ("estimate-unreliable"). The program computes in full f32 on
the CUDA cores (`device.set_full_f32` keeps TF32 off), so its flops are
held against the f32 peak. A count taken on the CPU is a count, never a
device time or a share: the CPU has no peaks here.
"""

from __future__ import annotations

import contextlib
import functools
import subprocess

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


# published peaks per card, keyed by torch.cuda.get_device_name() without
# its "NVIDIA " prefix: (f32 TFLOP/s outside the tensor cores, HBM GB/s),
# dense, at the full power limit. Source: NVIDIA's H100 and H200 Tensor
# Core GPU data sheets, SXM columns (H100 SXM: 67 TFLOP/s FP32, 3.35 TB/s
# HBM3; H200 SXM: 67 TFLOP/s FP32, 4.8 TB/s HBM3e). Any other name (the
# PCIe and NVL parts among them) has no entry: no share is printed.
_PEAKS = {
    "H100 80GB HBM3": (67.0, 3350.0),
    "H100 SXM": (67.0, 3350.0),
    "H200": (67.0, 4800.0),
}


def bound_label(flop_pct: float, hbm_pct: float) -> str:
    """Which wall is closer, given the shares (percent) of the f32 and HBM
    peaks: "dispatch" when both sit under 2% (fixed per-launch latency
    dominates); "estimate-unreliable" when either exceeds 100% of a
    physical peak (impossible traffic never prints as a saturated wall);
    else "hbm" or "flops" (reference roofline.py:50-61, whose "mxu" is
    "flops" here: the port's f32 runs on the CUDA cores)."""
    if max(hbm_pct, flop_pct) < 2.0:
        return "dispatch"
    if hbm_pct > 100.0 or flop_pct > 100.0:
        return "estimate-unreliable"
    return "hbm" if hbm_pct >= flop_pct else "flops"


def chip_peaks(device) -> tuple[float, float] | None:
    """(peak f32 TFLOP/s, peak HBM GB/s) of a card, given its name as
    torch.cuda.get_device_name() gives it or a torch.device; None for the
    CPU and for any card the table does not name. Never a guess."""
    if isinstance(device, torch.device):
        if device.type != "cuda":
            return None
        device = torch.cuda.get_device_name(device)
    name = str(device).strip().removeprefix("NVIDIA ").strip()
    return _PEAKS.get(name)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, found
    by the card's UUID; "cpu" for the CPU. Where nvidia-smi cannot say,
    the name and "power limit not read"."""
    if device.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    try:
        uuid = str(torch.cuda.get_device_properties(device).uuid)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (AttributeError, OSError, subprocess.SubprocessError):
        return f"{name}, power limit not read"
    for line in smi.stdout.splitlines():
        u, _, rest = line.partition(",")
        if u.strip().removeprefix("GPU-") == uuid.removeprefix("GPU-"):
            return rest.strip()
    return f"{name}, power limit not read"


# -- counting the work of tensor code ------------------------------------

_MATMULS = {"mm": 0, "bmm": 0, "matmul": 0, "addmm": 1}  # -> left operand
_REDUCTIONS = frozenset({
    "sum", "mean", "prod", "amax", "amin", "max", "min", "aminmax",
    "argmax", "argmin", "any", "all", "norm", "linalg_vector_norm", "var",
    "std", "var_mean", "std_mean", "logsumexp", "nansum", "count_nonzero",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
})
_GATHERS = frozenset({"index", "gather", "index_select", "take",
                      "embedding"})  # the source is the first argument
_MOVES = _GATHERS | frozenset({
    "copy_", "clone", "cat", "stack", "_to_copy", "flip", "roll", "repeat",
    "repeat_interleave", "constant_pad_nd", "narrow_copy", "masked_select",
    "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "index_add", "index_add_", "index_copy", "index_copy_", "slice_scatter",
    "select_scatter", "fill", "fill_", "zero_", "zeros", "zeros_like",
    "ones", "ones_like", "full", "full_like", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "new_zeros",
    "new_ones", "new_full", "arange", "lift_fresh_copy",
    "_local_scalar_dense",
})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> tuple[tuple, int]:
    """(key, bytes) of a tensor's storage; the key tells storages that are
    alive at the same time apart."""
    s = t.untyped_storage()
    return (t.device.type, t.device.index, s.data_ptr()), s.nbytes()


@functools.lru_cache(maxsize=None)
def _written_args(func) -> tuple[tuple[int, str], ...]:
    """(position, name) of the arguments an op writes (its schema's `!`)."""
    return tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                 if a.alias_info is not None and a.alias_info.is_write)


class WorkCount:
    """What one stretch of tensor code did: `flops`, `bytes` (the logical
    "bytes accessed"), `ops` (per aten op or kernel: [calls, flops,
    bytes]) and the storages it read, wrote and allocated (`memory`)."""

    def __init__(self) -> None:
        self.flops = 0.0
        self.bytes = 0.0
        self.ops: dict[str, list] = {}
        self.paused = 0
        self._born: dict[tuple, int] = {}  # key -> bytes, last allocation
        self._temp = 0                     # bytes of every allocation
        self._args: dict[tuple, int] = {}  # older storages read
        self._outs: dict[tuple, int] = {}  # older storages written

    def _tally(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.ops.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def _read(self, t: torch.Tensor) -> None:
        key, n = _storage(t)
        if n and key not in self._born:
            self._args[key] = n

    def _write(self, t: torch.Tensor) -> None:
        key, n = _storage(t)
        if n and key not in self._born:
            self._outs[key] = n

    def _allocated(self, t: torch.Tensor, n: int) -> None:
        key, _ = _storage(t)
        if n:
            self._born[key] = n
            self._temp += n

    def op(self, func, args, kwargs, out) -> None:
        """Count one aten op (called by the dispatch mode)."""
        name = str(func)
        base = func.overloadpacket.__name__
        if func.is_view or base == "_unsafe_view":  # a view of a new copy
            self._tally(name, 0.0, 0.0)
            return
        written = _written_args(func)
        wr = [args[i] if i < len(args) else kwargs.get(a)
              for i, a in written]
        wr = [t for t in tree_leaves(wr) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if base in _GATHERS and ins and outs:
            # the gathered elements, not the whole source
            nbytes += outs[0].numel() * ins[0].element_size() - _nbytes(ins[0])
        if base in _MOVES or not outs:
            flops = 0.0
        elif base in _MATMULS:
            left = args[_MATMULS[base]]
            flops = 2.0 * outs[0].numel() * left.shape[-1]
        elif base in _REDUCTIONS:
            flops = float(ins[0].numel()) if ins else 0.0
        else:
            flops = float(outs[0].numel())
        self._tally(name, flops, nbytes)
        written_ids = {id(t) for t in wr}
        in_keys = set()
        for t in ins:
            in_keys.add(_storage(t)[0])
            if id(t) in written_ids:
                self._write(t)
            else:
                self._read(t)
        for t in outs:
            key, n = _storage(t)
            if key not in in_keys:  # a new storage, not an input's
                self._allocated(t, n)

    def kernel(self, name: str, flops: float, nbytes: float, args,
               out) -> None:
        """Count one kernel wrapper's call: its recorded work, its tensor
        arguments as reads and its returned tensors as allocations of
        their own size (the kernel's outputs)."""
        self._tally(f"kernel:{name}", flops, nbytes)
        for t in tree_leaves(args):
            if isinstance(t, torch.Tensor):
                self._read(t)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._allocated(t, _nbytes(t))

    def memory(self, returned: torch.Tensor) -> dict[str, int]:
        """{arg_bytes, out_bytes, temp_bytes} of the counted stretch, the
        tensor it returned (the window's audio) an output, not a temp."""
        key, n = _storage(returned)
        out, temp = sum(self._outs.values()), self._temp
        if key in self._born:
            temp -= self._born[key]
            out += self._born[key]
        elif key not in self._outs:
            out += n
        return {"arg_bytes": sum(self._args.values()), "out_bytes": out,
                "temp_bytes": temp}


class _CountMode(TorchDispatchMode):
    def __init__(self, count: WorkCount) -> None:
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.count.paused:
            self.count.op(func, args, kwargs, out)
        return out


_ACTIVE: WorkCount | None = None  # the count in progress, if any


@contextlib.contextmanager
def count_work():
    """Count the work of the tensor code run inside (the rules in the
    module docstring); yields the WorkCount. Raises while a CUDA graph
    capture is in progress (a dispatch mode would see the capture's ops,
    not a run's) and inside another count."""
    global _ACTIVE
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("count_work: a CUDA graph capture is in progress")
    if _ACTIVE is not None:
        raise RuntimeError("count_work: a count is already active")
    count = _ACTIVE = WorkCount()
    try:
        with _CountMode(count):
            yield count
    finally:
        _ACTIVE = None


def counted(work):
    """Decorator of a kernel wrapper: under `count_work()` the wrapper's
    body runs uncounted (its launch, or its plain version on the CPU) and
    `work(*args, **kwargs)`, the kernel's (flops, bytes), is recorded in
    its place. A wrapper called inside another's body (a plain version
    built on kernel wrappers, as the eq3's) records nothing: the outer
    formula stands for it, as on the card. Its launch counter counts as
    before."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            count = _ACTIVE
            if count is None or count.paused:
                return fn(*args, **kwargs)
            count.paused += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                count.paused -= 1
            flops, nbytes = work(*args, **kwargs)
            count.kernel(fn.__name__, flops, nbytes, (args, kwargs), out)
            return out
        return wrapper
    return deco


# -- a config's roofline -------------------------------------------------

def _window_counts(st) -> dict[int, int] | None:
    """Window sizes a single-device render uses, as {nb: count}: the loop
    of State.render_device (engine/state.py). None under a mesh of more
    than one rank: the render dispatched sharded windows there, which
    window_cost does not model (reference roofline.py:76-92)."""
    _, n, step = st._mesh_plan()
    if n > 1:
        return None
    counts: dict[int, int] = {}
    left = st.cs
    while left > 0:
        nb = st._pick_nb(left, step, 1)
        counts[nb] = counts.get(nb, 0) + 1
        left -= nb
    return counts


def _resampler_flops(st, length_sec: float) -> float:
    """Flops of the render resample: one SINC_LEN-tap dot a channel an
    output frame (ops/resample.py), outside the window programs
    (reference roofline.py:95-105)."""
    from ..ops.resample import SINC_LEN

    if st.config.settings.project_samplerate <= st.render_sr:
        return 0.0
    return length_sec * st.render_sr * SINC_LEN * 2 * 2  # x channels x 2


def _analytic_window_model(cg, counts: dict[int, int]) -> tuple[float, float]:
    """The reference's crude floor (roofline.py:108-120): every vertex
    reads and writes a stereo f32 window and does about 12 flops a sample.
    (flops, bytes) over the windows of `counts`; chip_smoke prints it
    beside the count to show how far the floor was from the work."""
    n_v = max(1, len(cg.order))
    flops = byts = 0.0
    for nb, cnt in counts.items():
        frames = nb * cg.bl
        byts += n_v * frames * 2 * 4 * 2 * cnt
        flops += n_v * frames * 2 * 12 * cnt
    return flops, byts


def config_roofline(st, chip_s: float, length_sec: float) -> dict | None:
    """A config's flops and bytes over a render (window_cost of each window
    size times its count, plus the resample's flops) and their rates over
    the measured render time `chip_s`; on a card whose peaks `chip_peaks`
    knows, the shares of those peaks and the closer wall (reference
    roofline.py:123-213; "mxu_util_pct" is "flop_util_pct"). None under a
    mesh. Leaves the graph and the floww bank at time 0."""
    counts = _window_counts(st)
    if counts is None:
        return None
    cg = st.compiled
    _, _, step = st._mesh_plan()
    cg.seed_caps(st.fb, st.cs, step)
    cg.set_time(0)
    st.fb.set_time(0)
    flops = byts = phys = 0.0
    peak = None
    for nb, cnt in sorted(counts.items()):
        ca = cg.window_cost(st.fb, nb)
        flops += ca["flops"] * cnt
        byts += ca["bytes accessed"] * cnt
        mem = ca["_mem"]
        # every argument read once, every output written once, every temp
        # written and read once: physically scaled, an estimate either way
        phys += (mem["arg_bytes"] + mem["out_bytes"]
                 + 2 * mem["temp_bytes"]) * cnt
        if "peak_bytes" in mem:
            peak = max(peak or 0, mem["peak_bytes"])
    cg.set_time(0)
    st.fb.set_time(0)
    flops += _resampler_flops(st, length_sec)
    out = {
        "gflops_per_s": flops / chip_s / 1e9,
        "hbm_gbps_logical": byts / chip_s / 1e9,
        "window_gflops": flops / 1e9,
        "window_gbytes_logical": byts / 1e9,
        "source": ca["source"],
        "hbm_gbps_phys_est": phys / chip_s / 1e9,
        "window_gbytes_phys_est": phys / 1e9,
        "card": card_line(st.device),
    }
    if peak is not None:
        out["peak_hbm_window_mb"] = peak / 1e6
    peaks = chip_peaks(st.device)
    out["peaks"] = None if peaks is None else {
        "tflops_f32": peaks[0], "hbm_gbps": peaks[1]}
    if peaks is not None:
        out["flop_util_pct"] = flops / chip_s / (peaks[0] * 1e12) * 100.0
        out["hbm_util_pct"] = byts / chip_s / (peaks[1] * 1e9) * 100.0
        # the wall is judged by the physical estimate: a logical count
        # above the bus peak is fusion saving traffic, and a physical one
        # above it is impossible traffic, never printed as a share
        hbm_pct = phys / chip_s / (peaks[1] * 1e9) * 100.0
        if hbm_pct <= 100.0:
            out["hbm_util_pct_phys_est"] = hbm_pct
        else:
            out["phys_est_exceeds_peak"] = True
        out["bound"] = bound_label(out["flop_util_pct"], hbm_pct)
    return out
