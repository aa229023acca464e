"""A spec (see projects/__init__.py) as termdaw's project files: the TOML
settings and the Lua script of project-API calls."""

from __future__ import annotations

from pathlib import Path


def _num(v) -> str:
    return repr(float(v))


def _table(vals) -> str:
    return "{ " + ", ".join(_num(v) for v in vals) + " }"


def _bool(v) -> str:
    return "true" if v else "false"


def _vertex(v: dict) -> str:
    k, n = v["kind"], f'"{v["name"]}"'
    head = f'{n}, {_num(v.get("gain", 1.0))}, {_num(v.get("angle", 0.0))}'
    if k == "normalize":
        return f"add_normalize({head});"
    if k == "sample_multi":
        return (f'add_sample_multi({head}, "{v["sample"]}", "{v["floww"]}", '
                f'{_num(v["note"])});')
    if k == "sample_lerp":
        return (f'add_sample_lerp({head}, "{v["sample"]}", "{v["floww"]}", '
                f'{_num(v["note"])}, {int(v["lerp_len"])});')
    if k == "synth":
        (sqv, sqz, sqc), (tfv, tfz, tfc), (trv, trc) = (
            v["sq"], v["tf"], v["tr"])
        return (f'add_synth({head}, "{v["floww"]}", {_num(sqv)}, {_num(sqz)}, '
                f'{_table(sqc)}, {_num(tfv)}, {_num(tfz)}, {_table(tfc)}, '
                f'{_num(trv)}, {_table(trc)});')
    if k == "sampsyn":
        return (f'add_sampsyn({head}, "{v["floww"]}", {_table(v["conf"])}, '
                f'"{v["table"]}");')
    if k == "adsr":
        return (f'add_adsr({head}, {_num(v["wet"])}, "{v["floww"]}", '
                f'{_bool(v["use_off"])}, {_bool(v["use_max"])}, '
                f'{_num(v["note"])}, {_table(v["conf"])});')
    if k == "bandpass":
        return (f'add_bandpass({head}, {_num(v["wet"])}, '
                f'{_num(v["cut_low"])}, {_num(v["cut_high"])}, '
                f'{_bool(v["pass_mode"])});')
    if k == "fx":
        return (f'add_lv2fx({head}, {_num(v["wet"])}, "{v["plugin"]}");')
    raise ValueError(f"no Lua form for vertex kind {k!r}")


def lua_text(spec: dict, d: Path) -> str:
    d = Path(d)
    out = [
        f'set_length({_num(spec["length_s"])});',
        f'set_render_samplerate({int(spec["render_sr"])});',
        f'set_render_bitdepth({int(spec["bd"])});',
        f'set_output_file("{d / "outp.wav"}");',
    ]
    for name, f in spec.get("samples", {}).items():
        out.append(f'load_sample("{name}", "{d / f}", "");')
    for name, f in spec.get("midi", {}).items():
        out.append(f'load_midi_floww("{name}", "{d / f}");')
    for name in spec.get("streams", []):
        out.append(f'declare_stream("{name}");')
    for name, f in spec.get("tables", {}).items():
        out.append(f'load_resource("{name}", "{d / f}");')
    for name, p in spec.get("plugins", {}).items():
        out.append(f'load_lv2("{name}", "native:{p["kind"]}");')
        for key, val in p.get("params", {}).items():
            out.append(f'parameter("{name}", "{key}", {_num(val)});')
    out += [_vertex(v) for v in spec["vertices"]]
    out += [f'connect("{a}", "{b}");' for a, b in spec["edges"]]
    out.append(f'set_output("{spec["output"]}");')
    return "\n".join(out) + "\n"


def write_project(spec: dict, d: Path) -> None:
    """Write project.toml and project.lua of `spec` into d (the data files
    are already there)."""
    d = Path(d)
    (d / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\n'
        f'buffer_length = {int(spec["bl"])}\n'
        f'project_samplerate = {int(spec["sr"])}\n')
    (d / "project.lua").write_text(lua_text(spec, d))
