"""Carried over from termdaw_tpu/lua/__init__.py, so that the port imports
nothing of termdaw_tpu; only the usage line differs.

First-party Lua interpreter (a practical Lua 5.3 subset).

The reference embeds the Lua 5.3 C library via `mlua` (reference
Cargo.toml:13) and registers ~23 project-API globals inside a scope
(state.rs:83-159). This environment has no Lua binding, so the framework owns
an interpreter. It covers everything the reference's example scripts use
(assignments, table constructors, calls, comments — examples/*.lua,
project.lua) plus the general language facilities an algorithmic-composition
user expects: locals, closures, control flow, numeric/generic for, multiple
returns, method calls, and a small stdlib (math/string/table).

Usage:
    from termdaw_tpu_torch.lua import LuaRuntime, LuaError
    rt = LuaRuntime()
    rt.set_global("connect", lambda a, b: ...)
    rt.execute(source)
"""

from .interp import LuaRuntime, LuaError, LuaTable

__all__ = ["LuaRuntime", "LuaError", "LuaTable"]
