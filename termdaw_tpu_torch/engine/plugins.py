"""PluginHost: the named effect-plugin registry behind the load_lv2 API.

Counterpart of termdaw_tpu/engine/plugins.py with the same interface and
messages (add_plugin/remove_plugin/set_value/reset_value/get/get_index/
param_values/version, state.rs:254-323). URIs bind to the port's native
effect suite (ops/fx.py: `resolve_uri`), parameter names go through
`resolve_param` (lower-cased, LV2 display-name aliases). Traced parameter
values reach the window program as one f32 upload per change
(graph/compile.py `_pack_fx`, memoized on `version`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from termdaw_tpu.utils.term import BLUE, DEFAULT, RED, YELLOW

from ..ops.fx import EffectDef, resolve_param, resolve_uri


class AddPluginError(ValueError):
    """Unresolvable URI or duplicate name."""


@dataclass
class Plugin:
    name: str
    uri: str
    effect: EffectDef
    params: dict = field(default_factory=dict)  # overrides over defaults


class PluginHost:
    def __init__(self) -> None:
        self.plugins: list[Plugin | None] = []
        self.names: dict[str, int] = {}
        # bumped on every mutation that can change param_values() output;
        # CompiledGraph._pack_fx memoizes its packed vector against it
        self.version = 0

    def add_plugin(self, uri: str, name: str) -> None:
        if name in self.names:
            raise AddPluginError(
                f'PluginHost: plugin named "{name}" already present.'
            )
        effect = resolve_uri(uri)
        if effect is None:
            raise AddPluginError(
                f'PluginHost: no native effect matches uri "{uri}". '
                f"Known: reverb, chorus, compressor, tape, delay, bitcrush "
                f'(use e.g. "native:reverb").'
            )
        self.plugins.append(Plugin(name=name, uri=uri, effect=effect))
        self.names[name] = len(self.plugins) - 1
        self.version += 1

    def remove_plugin(self, name: str) -> None:
        idx = self.names.pop(name, None)
        if idx is not None:
            self.plugins[idx] = None
            self.version += 1

    def get_index(self, name: str) -> int | None:
        return self.names.get(name)

    def get(self, index: int) -> Plugin:
        p = self.plugins[index]
        if p is None:
            raise KeyError(f"PluginHost: plugin {index} was removed")
        return p

    def set_value(self, plugin: str, param: str, value: float) -> None:
        idx = self.names.get(plugin)
        if idx is None:
            print(f'{RED}PluginHost: unknown plugin "{plugin}".{DEFAULT}')
            return
        key = resolve_param(param)
        p = self.get(idx)
        if key is None or key not in p.effect.defaults:
            print(
                f'{YELLOW}PluginHost: plugin {BLUE}"{plugin}"{YELLOW} has no '
                f'parameter {BLUE}"{param}"{YELLOW}; known: '
                f"{sorted(p.effect.defaults)}{DEFAULT}"
            )
            return
        p.params[key] = float(value)
        self.version += 1

    def reset_value(self, plugin: str, param: str) -> None:
        idx = self.names.get(plugin)
        if idx is None:
            return
        key = resolve_param(param)
        if key is not None and self.get(idx).params.pop(key, None) is not None:
            self.version += 1

    def param_values(self, index: int) -> dict[str, float]:
        p = self.get(index)
        return {**p.effect.defaults, **p.params}
