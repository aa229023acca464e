"""termdaw_tpu_torch — the PyTorch/CUDA port of termdaw_tpu.

A second package beside `termdaw_tpu/` (the JAX reference, which stays as
it is). It takes the same `project.toml` and Lua script and renders the
same WAV, with PyTorch tensors on an explicit device and hand-written
CUDA kernels for Hopper where the reference had Pallas kernels.

This package imports `torch` and never `jax`: from `termdaw_tpu` it uses
only the JAX-free host layers (`lua`, `fileio`, `banks.flowwbank`,
`banks.bufferbank`, `config`, `utils.term`, `utils.prof.span`,
`engine.sink`, `workflows.palette`). Everything else it needs is carried
over as a module of its own, whose docstring names the file it came from.

Ported so far: the offline render (`State.render`) and playback (`play`
in the manual workflow) of graphs made of every vertex kind but the
effects: Sum, Normalize, SampleLoop, SampleMulti, SampleLerp, DebugSine,
Synth, SampSyn, Adsr and BandPass. `load_lv2` and effect vertices abort
the refresh with a "not yet ported" message.

    python -m termdaw_tpu_torch [--device cuda|cpu] [workdir]
"""

from .device import set_full_f32

set_full_f32()

__version__ = "0.1.0"
