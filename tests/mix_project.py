"""What the vertex epilogue's tests (mix.vertex_post) share on the CPU
(tests/test_torch_ops.py) and the card (tests/test_torch_cuda.py): a
plan of given wet, angle and gain, and a small mix session. Imports
nothing of JAX or termdaw_tpu."""

from pathlib import Path

import numpy as np
import torch

from termdaw_tpu_torch.ops import mix
from termdaw_tpu_torch.utils.fixtures import drum


def post_plan(dev, wet, angle: float, gain: float) -> mix.VertexPost:
    """The plan of a vertex that blends at `wet` (None: no blend), its
    flags from post_flags and its pan factors from pan_amps, on dev."""
    a = torch.tensor(np.float32(angle), device=dev)
    pan_on, gain_on = mix.post_flags(angle, gain)
    return mix.VertexPost(
        blend=wet is not None, pan_on=bool(pan_on), gain_on=bool(gain_on),
        wet=torch.tensor(np.float32(0.0 if wet is None else wet),
                         device=dev),
        angle=a, gain=torch.tensor(np.float32(gain), device=dev),
        pan=mix.pan_amps(a))


def write_mix_project(d: Path, sr: int = 16000, bl: int = 256,
                      length: float = 1.5, bd: int = 24) -> None:
    """A small mix session: three SampleLoop tracks through tape -> eq3 ->
    compressor (a chorus at wet 0.5 on the second), the last insert panned
    and gained, into a mix bus; the first also through a gained send Sum
    into a reverb return; a Normalize at the end, bounced at `bd` bits.
    The loops, the buses and the Normalize have nothing to do in their
    epilogue."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    lines = [f"set_length({length});", f"set_render_samplerate({sr});",
             f"set_render_bitdepth({bd});",
             f'set_output_file("{d}/outp.wav");',
             'add_sum("mixbus", 1.0, 0.0);', 'add_sum("verbbus", 1.0, 0.0);',
             'add_sum("send0", 0.2, 0.0);', 'add_normalize("out", 1.0, 0.0);',
             'load_lv2("verb", "native:reverb");',
             'add_lv2fx("verb", 1.0, 0.0, 1.0, "verb");']
    edges = [("send0", "verbbus"), ("verbbus", "verb"), ("verb", "mixbus"),
             ("mixbus", "out")]
    pans = ((0.7, -35.0), (0.9, 20.0), (0.55, 0.0005))
    for i, (gain, angle) in enumerate(pans):
        drum(d / f"stem{i}.wav", sr, 0.4 + 0.2 * i, 80.0 * (i + 1), 9.0,
             noise=0.3 * i, seed=i)
        lines += [f'load_sample("stem{i}", "{d}/stem{i}.wav", "");',
                  f'add_sampleloop("track{i}", 1.0, 0.0, "stem{i}");']
        kinds = ["tape", "eq3", "compressor"] + (["chorus"] if i == 1 else [])
        names = [f"track{i}"]
        for j, kind in enumerate(kinds):
            last = j == len(kinds) - 1
            name = f"{kind}{i}"
            lines += [f'load_lv2("{name}", "native:{kind}");',
                      f'add_lv2fx("{name}", {gain if last else 1.0}, '
                      f'{angle if last else 0.0}, '
                      f'{0.5 if kind == "chorus" else 1.0}, "{name}");']
            names.append(name)
        edges += list(zip(names, names[1:])) + [(names[-1], "mixbus")]
        if i == 0:
            edges.append((names[-1], "send0"))
    lines += [f'connect("{a}", "{b}");' for a, b in edges]
    lines.append('set_output("out");')
    (d / "project.lua").write_text("\n".join(lines) + "\n")
    (d / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\nbuffer_length = {bl}\n'
        f"project_samplerate = {sr}\n")
