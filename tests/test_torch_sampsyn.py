"""The SampSyn arm's wrapper (termdaw_tpu_torch/ops/synthv.sampsyn) on the
CPU: CPU tensors run the plain version (sampsyn_plain, the body the
window program ran before the arm had a kernel) and return what it
returns, bit for bit, at c4's chord shape; the wrapper's checks of
devices, dtypes, shapes and contiguity; its work formula; and a CPU
window's count (utils/roofline.count_work) of the arm, which is that
formula and none of the plain version's ops. The kernel itself
(csrc/sampsyn.cu) is held to the plain version on the card in
tests/test_torch_cuda.py. Imports nothing of JAX or termdaw_tpu."""

import numpy as np
import pytest
import torch

from termdaw_tpu_torch.ops import synthv
from termdaw_tpu_torch.ops.adsr import hit_conf
from termdaw_tpu_torch.utils import roofline
from termdaw_tpu_torch.utils.fixtures import (
    load_state, sampsyn_window, write_c3_project,
)

CPU = torch.device("cpu")
CONF = hit_conf(0.01, 0.1, 0.8, 5.0, 0.2, 0.5)  # the fixtures' chord conf


def _clone(args):
    return tuple({k: v.clone() for k, v in a.items()} if isinstance(a, dict)
                 else a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


def _spy(monkeypatch):
    """Records each sampsyn_plain call of the window program: its
    arguments and what it returned, cloned (the program's buffers are
    rewritten by the next window)."""
    calls = []
    plain = synthv.sampsyn_plain

    def spy(*args):
        out = plain(*args)
        calls.append((_clone(args), out.clone()))
        return out

    monkeypatch.setattr(synthv, "sampsyn_plain", spy)
    return calls


def test_sampsyn_on_cpu_returns_the_plain_body_on_c4_chords():
    """The wrapper's dispatch on CPU tensors, at c4's chord shape (blocks of
    1024 frames, 8 slots, the default 2 x 2048 wavetable, the chords'
    envelope; 4 blocks): it returns sampsyn_plain's bits, on fresh
    arguments and on those of a first call, and counts no launch."""
    nb, bl = 4, 1024
    bake, frames, ib, times, waves = sampsyn_window(CPU, nb, bl, 8, 24,
                                                    seed=5)
    args = (bake, frames, nb, bl, CONF, times, waves, ib)
    n0 = synthv.sampsyn_launches
    got = synthv.sampsyn(*args)
    want = synthv.sampsyn_plain(*_clone(args))
    assert float(want.abs().max()) > 0.01
    assert torch.equal(got, want)
    assert torch.equal(synthv.sampsyn(*args), got)
    assert synthv.sampsyn_launches == n0


def _args(nb=4, bl=64, P=4, N=6, K=2, W=32):
    bake, frames, ib, times, waves = sampsyn_window(CPU, nb, bl, P, N, K=K,
                                                    W=W, seed=1)
    return [bake, frames, nb, bl, CONF, times, waves, ib]


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _all_meta(a):
    a[0] = {k: _meta(v) for k, v in a[0].items()}
    for i in (1, 5, 6, 7):
        a[i] = _meta(a[i])


def _bake(key, fn):
    def f(a):
        a[0] = dict(a[0])
        a[0][key] = fn(a[0][key])
    return f


def _arg(i, fn):
    def f(a):
        a[i] = fn(a[i])
    return f


def _drop(key):
    def f(a):
        a[0] = {k: v for k, v in a[0].items() if k != key}
    return f


def _strided(t):
    return torch.stack([t, t], dim=-1)[..., 0]  # same shape, stride 2


BAD = {
    "device_bake": (_bake("vels", _meta), ValueError, "on meta"),
    "device_table": (_arg(6, _meta), ValueError, "on meta"),
    "device_unsupported": (_all_meta, ValueError, "unsupported device"),
    "dtype_idx": (_bake("idx", lambda t: t.long()), TypeError, "idx is"),
    "dtype_on_f": (_bake("on_f", lambda t: t.long()), TypeError, "on_f is"),
    "dtype_frames": (_arg(1, lambda t: t.int()), TypeError, "frames is"),
    "dtype_ib": (_arg(7, lambda t: t.double()), TypeError, "ib is"),
    "dtype_waves": (_arg(6, lambda t: t.double()), TypeError,
                    "table_waves is"),
    "missing_column": (_drop("cyc"), ValueError, "has no cyc"),
    "shape_idx": (_bake("idx", lambda t: t[:-1].contiguous()), ValueError,
                  "idx must be"),
    "shape_frames": (_arg(1, lambda t: t[:-1].contiguous()), ValueError,
                     "frames must be"),
    "shape_ib": (_arg(7, lambda t: torch.cat([t, t[:1]])), ValueError,
                 "ib must be"),
    "shape_rel_t": (_bake("rel_t", lambda t: t[:-1].contiguous()),
                    ValueError, "rel_t must be"),
    "shape_env_ads0": (_bake("env_ads0", lambda t: t[:, :-1].contiguous()),
                       ValueError, "env_ads0 must be"),
    "shape_table": (_arg(5, lambda t: t[:1].contiguous()), ValueError,
                    "must agree"),
    "contiguous_waves": (_arg(6, _strided), ValueError,
                         "table_waves is not contiguous"),
    "contiguous_env_rel0": (_bake("env_rel0", _strided), ValueError,
                            "env_rel0 is not contiguous"),
    "contiguous_frames": (_arg(1, _strided), ValueError,
                          "frames is not contiguous"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_sampsyn_wrapper_refuses_bad_arguments(case):
    """Each wrong device, dtype, shape, contiguity or missing column
    raises before anything runs; the arguments as they come run."""
    change, err, match = BAD[case]
    a = _args()
    assert synthv.sampsyn(*a).shape == (4 * 64, 2)
    change(a)
    with pytest.raises(err, match=match):
        synthv.sampsyn(*a)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_sampsyn_work_formula(K):
    """SAMPSYN_FLOPS (18) f32 operations a slot-frame, 10 more with K > 1
    snapshots to blend; the frames (int64), the in-block clock, the nine
    bake columns and the wavetable read once, the stereo mix written
    once."""
    nb, bl, P, N, W = 5, 48, 3, 7, 40
    a = _args(nb, bl, P, N, K, W)
    flops, nbytes = synthv.sampsyn_work(*a)
    per = 18 + (10 if K > 1 else 0)
    assert flops == nb * bl * P * per
    ins = (nb * bl * 8 + bl * 4 + K * 4 + K * W * 4 + nb * P * 4
           + 6 * N * 4 + 2 * nb * N * 4)
    assert nbytes == ins + nb * bl * 2 * 4
    with roofline.count_work() as w:
        synthv.sampsyn(*a)
    assert w.ops == {"kernel:sampsyn": [1, flops, nbytes]}


def test_cpu_window_counts_the_sampsyn_arm_as_its_formula(tmp_path,
                                                          monkeypatch):
    """window_cost of a c3 window on the CPU counts the SampSyn arm as one
    `kernel:sampsyn` row of sampsyn_work's numbers for the window's
    arguments, and none of the plain version's own ops (its
    searchsorted) though the plain version ran."""
    write_c3_project(tmp_path, 2.0, 8000, 64)
    st = load_state(tmp_path, CPU)
    calls = _spy(monkeypatch)
    (nb,) = roofline._window_counts(st)
    cost = st.compiled.window_cost(st.fb, nb)
    assert len(calls) == 1
    flops, nbytes = synthv.sampsyn_work(*calls[0][0])
    assert cost["ops"]["kernel:sampsyn"] == [1, flops, nbytes]
    assert flops == nb * 64 * calls[0][0][0]["idx"].shape[1] * 28
    assert not any("searchsorted" in k for k in cost["ops"])


def test_sampsyn_params_are_the_plain_versions_operands():
    """The kernel's constants: the envelope's f32 edges and durations, the
    slopes as numpy f32 differences, zero-length segments flagged, the
    amplitude and W / 2^32 rounded to f32 as torch rounds a Python
    float."""
    from termdaw_tpu_torch.ops.adsr import AdsrConf

    conf = AdsrConf(0.2, 0.0, 1.0, 0.05, 0.5, 0.1, 0.3, 0.0, 0.0)
    p = synthv._sampsyn_params(conf, 600)
    f32 = np.float32
    assert (p.att_on, p.dec_on, p.sus_on, p.release_on) == (0, 1, 1, 0)
    assert p.att_slope == float(f32(1.0) - f32(0.2))
    assert p.ad == float(f32(f32(0.0) + f32(0.05)))
    assert p.ads_end == float(f32(f32(f32(0.0) + f32(0.05)) + f32(0.1)))
    assert p.dec_div == float(f32(0.05)) and p.sus_div == float(f32(0.1))
    assert p.amp == float(f32(1.0 / 1.0))
    assert p.wscale == 600 / 2.0**32
    silent = synthv._sampsyn_params(AdsrConf(), 2048)
    assert silent.amp == 0.0
