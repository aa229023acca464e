"""Carried over from termdaw_tpu/lua/interp.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

Lua tree-walking interpreter.

Implements the semantics the project scripts need: lexical scoping with
closures, Lua 5.3-style integer/float arithmetic, tables with array+hash
parts, multiple return values, method calls, and the control-flow statements.
Host (Python) functions are registered as globals — the project API layer
(termdaw_tpu.engine.state) registers the ~23 DAW functions exactly like the
reference registers scoped mlua functions (reference state.rs:83-159).
"""

from __future__ import annotations

import math
from .parser import parse
from .lexer import LuaSyntaxError
from .coroutines import Coroutine, CoroutineError, co_yield, current_coroutine


class LuaError(RuntimeError):
    pass


# sentinel distinguishing "no metamethod" from a metamethod returning nil
_MISSING = object()

# arithmetic operator → metamethod event (Lua 5.3 §2.4)
_ARITH_EVENTS = {
    "+": "__add", "-": "__sub", "*": "__mul", "/": "__div",
    "%": "__mod", "^": "__pow", "//": "__idiv",
    "&": "__band", "|": "__bor", "~": "__bxor",
    "<<": "__shl", ">>": "__shr",
}


class LuaTable:
    """A Lua table: contiguous 1-based array part + hash part + metatable."""

    __slots__ = ("hash", "metatable", "_border")

    def __init__(self):
        self.hash: dict = {}
        self.metatable: "LuaTable | None" = None
        # cached array border (largest n with 1..n all present). Kept
        # incrementally so table.insert-driven array building is O(n)
        # total, not O(n^2) (length() used to rescan from 1 every call).
        self._border: int = 0

    def get(self, key):
        key = _normalize_key(key)
        return self.hash.get(key)

    def get_meta(self, event: str):
        if self.metatable is None:
            return None
        return self.metatable.hash.get(event)

    def set(self, key, value):
        key = _normalize_key(key)
        if key is None:
            raise LuaError("table index is nil")
        if value is None:
            self.hash.pop(key, None)
            if isinstance(key, int) and 1 <= key <= self._border:
                self._border = key - 1  # any border is valid past a hole
        else:
            self.hash[key] = value
            if isinstance(key, int) and key == self._border + 1:
                n = key
                while (n + 1) in self.hash:  # absorb keys set out of order
                    n += 1
                self._border = n

    def length(self) -> int:
        # border semantics: contiguous integer keys from 1 (cached)
        return self._border

    def array_items(self) -> list:
        return [self.hash[i] for i in range(1, self.length() + 1)]

    def items(self):
        return self.hash.items()

    def __repr__(self):
        return f"LuaTable({self.hash!r})"


def _normalize_key(key):
    # Lua: 2.0 and 2 are the same key
    if isinstance(key, float) and key.is_integer():
        return int(key)
    return key


class _Break(Exception):
    pass


class _Goto(Exception):
    """In-flight `goto name`. Unwinds to the nearest enclosing block that
    declares `::name::` (loops pass it through — only _Break is theirs),
    and is converted to a LuaError at function boundaries, where real Lua
    rejects the jump at compile time (Lua 5.3 §3.3.4)."""

    def __init__(self, name: str, line: int):
        self.name = name
        self.line = line


class _Return(Exception):
    def __init__(self, values: tuple):
        self.values = values


class LuaFunction:
    __slots__ = ("params", "is_vararg", "block", "env", "rt")

    def __init__(self, params, is_vararg, block, env, rt):
        self.params = params
        self.is_vararg = is_vararg
        self.block = block
        self.env = env
        self.rt = rt

    def __call__(self, *args):
        scope = Scope(self.env)
        for i, p in enumerate(self.params):
            scope.declare(p, args[i] if i < len(args) else None)
        if self.is_vararg:
            scope.varargs = tuple(args[len(self.params):])
        try:
            self.rt._exec_block(self.block, scope)
        except _Return as r:
            return r.values
        except _Goto as g:
            raise LuaError(
                f"lua: line {g.line}: no visible label '{g.name}' for goto"
            ) from None
        return ()


class _Cell:
    """One local variable slot, shared between a scope and any closures
    that captured it (real Lua upvalue semantics, §3.5). Cell capture —
    rather than whole-scope capture — means a closure retains ONLY the
    variables its body mentions: a coroutine parked on its thread no
    longer pins every sibling local of its creation scope (the thread →
    scope → coroutine reference cycle made abandoned coroutines
    unreclaimable, VERDICT r4 weak 6)."""

    __slots__ = ("v",)

    def __init__(self, v=None):
        self.v = v


class Scope:
    __slots__ = ("vars", "parent", "varargs")

    def __init__(self, parent=None):
        self.vars: dict[str, _Cell] = {}
        self.parent = parent
        self.varargs: tuple | None = None

    def declare(self, name, value):
        self.vars[name] = _Cell(value)

    def lookup(self, name):
        s = self
        while s is not None:
            cell = s.vars.get(name)
            if cell is not None:
                return s, cell.v
            s = s.parent
        return None, None

    def find_cell(self, name) -> _Cell | None:
        s = self
        while s is not None:
            cell = s.vars.get(name)
            if cell is not None:
                return cell
            s = s.parent
        return None

    def find_varargs(self):
        s = self
        while s is not None:
            if s.varargs is not None:
                return s.varargs
            s = s.parent
        return ()


def lua_tostring(v) -> str:
    if v is None:
        return "nil"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float):
        if v.is_integer() and abs(v) < 1e16:
            return f"{v:.1f}"
        return repr(v)
    if isinstance(v, int):
        return str(v)
    if isinstance(v, str):
        return v
    if isinstance(v, LuaTable):
        return f"table: 0x{id(v):012x}"
    if isinstance(v, Coroutine):
        return f"thread: 0x{id(v):012x}"
    if callable(v):
        return f"function: 0x{id(v):012x}"
    return str(v)


def _tonumber(v, base=None):
    if base is not None:
        try:
            return int(str(v).strip(), int(base))
        except ValueError:
            return None
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v
    if isinstance(v, str):
        s = v.strip()
        try:
            if s.lower().startswith("0x") or s.lower().startswith("-0x"):
                return int(s, 16)
            if any(c in s for c in ".eE") and not s.lower().startswith("0x"):
                return float(s)
            return int(s)
        except ValueError:
            try:
                return float(s)
            except ValueError:
                return None
    return None


def _arith_operand(v, op):
    n = _tonumber(v) if not isinstance(v, bool) else None
    if n is None:
        raise LuaError(
            f"attempt to perform arithmetic ({op}) on a {lua_type(v)} value"
        )
    return n


def lua_type(v) -> str:
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, LuaTable):
        return "table"
    if isinstance(v, Coroutine):
        return "thread"
    if callable(v):
        return "function"
    return "userdata"


def _build_stdlib(rt: "LuaRuntime") -> dict:
    def _print(*args):
        print("\t".join(lua_tostring(a) for a in args))
        return ()

    def _ipairs(t):
        if not isinstance(t, LuaTable):
            raise LuaError("bad argument to 'ipairs' (table expected)")

        def it(tbl, i):
            i = int(i) + 1
            v = tbl.get(i)
            if v is None:
                return (None,)
            return (i, v)

        return (it, t, 0)

    def _pairs(t):
        if not isinstance(t, LuaTable):
            raise LuaError("bad argument to 'pairs' (table expected)")
        keys = list(t.hash.keys())
        pos = {k: i for i, k in enumerate(keys)}  # O(1) control-var steps

        def it(tbl, key):
            if key is None:
                idx = 0
            else:
                idx = pos.get(_normalize_key(key), len(keys) - 1) + 1
            while idx < len(keys):
                k = keys[idx]
                if k in tbl.hash:
                    return (k, tbl.hash[k])
                idx += 1
            return (None,)

        return (it, t, None)

    def _insert(t, *args):
        if len(args) == 1:
            t.set(t.length() + 1, args[0])
        else:
            pos, val = int(args[0]), args[1]
            n = t.length()
            for i in range(n, pos - 1, -1):
                t.set(i + 1, t.get(i))
            t.set(pos, val)
        return ()

    def _remove(t, pos=None):
        n = t.length()
        if n == 0:
            return (None,)
        pos = n if pos is None else int(pos)
        v = t.get(pos)
        for i in range(pos, n):
            t.set(i, t.get(i + 1))
        t.set(n, None)
        return (v,)

    def _concat(t, sep="", i=1, j=None):
        j = t.length() if j is None else int(j)
        return sep.join(lua_tostring(t.get(k)) for k in range(int(i), j + 1))

    def _sfmt(fmt, *args):
        out = []
        ai = 0
        i = 0
        while i < len(fmt):
            c = fmt[i]
            if c != "%":
                out.append(c)
                i += 1
                continue
            j = i + 1
            while j < len(fmt) and fmt[j] in "-+ #0123456789.":
                j += 1
            conv = fmt[j]
            spec = fmt[i : j + 1]
            if conv == "%":
                out.append("%")
            else:
                a = args[ai]
                ai += 1
                if conv in "di":
                    out.append(spec[:-1].replace("%", "%") % 0 if False else
                               (spec[:-1] + "d") % int(a))
                elif conv in "eEfgG":
                    out.append(spec % float(a))
                elif conv == "s":
                    out.append(spec % lua_tostring(a))
                elif conv == "q":
                    out.append('"' + str(a).replace("\\", "\\\\")
                               .replace('"', '\\"').replace("\n", "\\n") + '"')
                elif conv in "xXo":
                    out.append(spec % int(a))
                elif conv == "c":
                    out.append(chr(int(a)))
                else:
                    raise LuaError(f"invalid format spec {spec!r}")
            i = j + 1
        return "".join(out)

    def _sub(s, i, j=-1):
        n = len(s)
        i, j = int(i), int(j)
        if i < 0:
            i = max(n + i + 1, 1)
        elif i == 0:
            i = 1
        if j < 0:
            j = n + j + 1
        elif j > n:
            j = n
        if i > j:
            return ""
        return s[i - 1 : j]

    mathlib = LuaTable()
    for name, fn in {
        "floor": lambda x: math.floor(x),
        "ceil": lambda x: math.ceil(x),
        "abs": lambda x: abs(x),
        "sqrt": lambda x: math.sqrt(x),
        "sin": lambda x: math.sin(x),
        "cos": lambda x: math.cos(x),
        "tan": lambda x: math.tan(x),
        "asin": lambda x: math.asin(x),
        "acos": lambda x: math.acos(x),
        "atan": lambda y, x=1.0: math.atan2(y, x),
        "exp": lambda x: math.exp(x),
        "log": lambda x, base=math.e: math.log(x, base),
        "pow": lambda x, y: float(x) ** float(y),
        "fmod": lambda x, y: math.fmod(x, y),
        "max": lambda *a: max(a),
        "min": lambda *a: min(a),
        "random": _lua_random,
        "randomseed": lambda x=None: (_RNG.seed(x), ())[1],
        "tointeger": lambda x: int(x) if _tonumber(x) is not None
        and float(x) == int(float(x)) else None,
        "type": lambda x: (
            None if isinstance(x, bool) or not isinstance(x, (int, float))
            else ("integer" if isinstance(x, int) else "float")
        ),
        "modf": lambda x: (float(math.floor(x)) if x >= 0
                           else float(math.ceil(x)), x - (math.floor(x) if x >= 0
                                                          else math.ceil(x))),
        "ult": lambda a, b: (int(a) & (2**64 - 1)) < (int(b) & (2**64 - 1)),
    }.items():
        mathlib.set(name, fn)
    mathlib.set("pi", math.pi)
    mathlib.set("huge", math.inf)
    mathlib.set("maxinteger", 2**63 - 1)
    mathlib.set("mininteger", -(2**63))

    from .patterns import (
        lua_find, lua_match, lua_gmatch, lua_gsub, LuaPatternError,
    )

    def _wrap_pat(fn):
        def inner(*a):
            try:
                return fn(*a)
            except LuaPatternError as e:
                raise LuaError(str(e)) from None

        return inner

    stringlib = LuaTable()
    for name, fn in {
        "format": _sfmt,
        "len": lambda s: len(s),
        "sub": _sub,
        "rep": lambda s, n, sep="": (sep.join([s] * int(n)) if n > 0 else ""),
        "upper": lambda s: s.upper(),
        "lower": lambda s: s.lower(),
        "byte": lambda s, i=1: ord(s[int(i) - 1]),
        "char": lambda *a: "".join(chr(int(x)) for x in a),
        "reverse": lambda s: s[::-1],
        "find": _wrap_pat(lua_find),
        "match": _wrap_pat(lua_match),
        "gmatch": _wrap_pat(lua_gmatch),
        "gsub": _wrap_pat(lua_gsub),
    }.items():
        stringlib.set(name, fn)

    def _sort(t, comp=None):
        import functools

        items = t.array_items()

        # Lua `<` semantics (numbers or strings; tables via __lt;
        # anything else errors)
        def default_lt(a, b):
            if isinstance(a, str) and isinstance(b, str):
                return a < b
            if (isinstance(a, (int, float)) and not isinstance(a, bool)
                    and isinstance(b, (int, float)) and not isinstance(b, bool)):
                return a < b
            res = rt._meta_bin("__lt", a, b)
            if res is not _MISSING:
                return _truthy(res)
            raise LuaError(
                f"attempt to compare {lua_type(a)} with {lua_type(b)}"
            )

        if comp is None:
            lt = default_lt
        else:
            def lt(a, b):
                res = comp(a, b)
                if isinstance(res, tuple):
                    res = res[0] if res else None
                return _truthy(res)

        items.sort(key=functools.cmp_to_key(
            lambda a, b: -1 if lt(a, b) else (1 if lt(b, a) else 0)
        ))
        for i, v in enumerate(items, start=1):
            t.set(i, v)
        return ()

    def _pack(*a):
        t = LuaTable()
        for i, v in enumerate(a, start=1):
            t.set(i, v)
        t.set("n", len(a))
        return t

    tablelib = LuaTable()
    tablelib.set("insert", _insert)
    tablelib.set("remove", _remove)
    tablelib.set("concat", _concat)
    tablelib.set("sort", _sort)
    tablelib.set("pack", _pack)
    tablelib.set("unpack", lambda t: tuple(t.array_items()))

    # coroutine library (Lua 5.3 §6.2) on handoff threads — see
    # lua/coroutines.py for the suspension model
    def _co_arg(co, fname):
        if not isinstance(co, Coroutine):
            raise LuaError(
                f"bad argument #1 to '{fname}' (coroutine expected, "
                f"got {lua_type(co)})"
            )
        return co

    def _co_create(f):
        try:
            return Coroutine(f)
        except CoroutineError as e:
            raise LuaError(str(e)) from None

    def _co_resume(co, *a):
        return _co_arg(co, "resume").resume(*a)

    def _co_yield(*a):
        try:
            return co_yield(*a)
        except CoroutineError as e:
            raise LuaError(str(e)) from None

    def _co_status(co):
        return _co_arg(co, "status").status

    def _co_wrap(f):
        co = _co_create(f)

        def wrapped(*a):
            res = co.resume(*a)
            if res[0] is not True:
                raise LuaError(lua_tostring(res[1]) if len(res) > 1
                               else "error in coroutine")
            return res[1:]

        return wrapped

    def _co_running():
        co = current_coroutine()
        # (running coroutine or nil on the main thread, is_main) — the
        # main thread has no first-party object here, a documented
        # deviation from returning the main thread handle
        return (co, co is None)

    def _co_close(co):
        # Lua 5.4 §6.2 coroutine.close (VERDICT r4 weak 6): reclaims a
        # suspended coroutine's parked thread; errors on running/normal
        try:
            return _co_arg(co, "close").close()
        except CoroutineError as e:
            raise LuaError(str(e)) from None

    colib = LuaTable()
    colib.set("create", _co_create)
    colib.set("resume", _co_resume)
    colib.set("yield", _co_yield)
    colib.set("status", _co_status)
    colib.set("wrap", _co_wrap)
    colib.set("close", _co_close)
    colib.set("isyieldable", lambda: current_coroutine() is not None)
    colib.set("running", _co_running)

    def _assert(v, msg=None, *rest):
        if v is None or v is False:
            raise LuaError(msg if msg is not None else "assertion failed!")
        return (v, msg, *rest)

    def _error(msg, _level=1):
        raise LuaError(lua_tostring(msg))

    def _pcall(fn, *args):
        try:
            res = fn(*args)
            if not isinstance(res, tuple):
                res = (res,) if res is not None else ()
            return (True, *res)
        except (LuaError, ZeroDivisionError) as e:
            return (False, str(e))

    def _select(n, *args):
        if n == "#":
            return len(args)
        n = int(n)
        if n < 0:
            # negative n counts from the end: select(-1, ...) is the LAST
            # value only (args[n-1:] was off by one)
            if -n > len(args):
                raise LuaError(
                    "bad argument #1 to 'select' (index out of range)"
                )
            return args[n:]
        if n == 0:
            raise LuaError("bad argument #1 to 'select' (index out of range)")
        return args[n - 1 :]

    def _setmetatable(t, mt):
        if not isinstance(t, LuaTable):
            raise LuaError("bad argument to 'setmetatable' (table expected)")
        if mt is not None and not isinstance(mt, LuaTable):
            raise LuaError("bad argument #2 to 'setmetatable'")
        t.metatable = mt
        return t

    def _getmetatable(t):
        return t.metatable if isinstance(t, LuaTable) else None

    def _rawget(t, k):
        return t.get(k)

    def _rawset(t, k, v):
        t.set(k, v)
        return t

    def _rawequal(a, b):
        return a is b if isinstance(a, LuaTable) else _lua_eq(a, b)

    def _rawlen(t):
        if isinstance(t, str):
            return len(t)
        return t.length()

    return {
        "print": _print,
        "setmetatable": _setmetatable,
        "getmetatable": _getmetatable,
        "rawget": _rawget,
        "rawset": _rawset,
        "rawequal": _rawequal,
        "rawlen": _rawlen,
        "ipairs": _ipairs,
        "pairs": _pairs,
        "tostring": lua_tostring,
        "tonumber": _tonumber,
        "type": lua_type,
        "assert": _assert,
        "error": _error,
        "pcall": _pcall,
        "select": _select,
        "unpack": lambda t: tuple(t.array_items()),
        "math": mathlib,
        "string": stringlib,
        "table": tablelib,
        "coroutine": colib,
    }


import random as _random_mod

_RNG = _random_mod.Random(0)


def _lua_random(m=None, n=None):
    if m is None:
        return _RNG.random()
    if n is None:
        return _RNG.randint(1, int(m))
    return _RNG.randint(int(m), int(n))


class LuaRuntime:
    """One Lua VM. Globals persist across `execute` calls, like the
    reference's single `Lua` instance living in State (state.rs:28)."""

    def __init__(self):
        self.globals: dict = {}
        self.globals.update(_build_stdlib(self))
        # free-name sets per function body, keyed by id() with the block
        # pinned alongside (tuples aren't weakref-able; pinning prevents
        # id reuse). One AST is walked once no matter how many closures
        # a loop mints over it.
        self._names_memo: dict[int, tuple] = {}

    def _names_in(self, block) -> frozenset:
        """Every variable name referenced anywhere in the subtree
        (("name", str) nodes), shadowed or not — a deliberate
        over-approximation: capturing an extra cell only retains one
        value slot, while missing one would break the closure."""
        memo = self._names_memo.get(id(block))
        if memo is not None:
            return memo[1]
        names: set[str] = set()
        stack: list = [block]
        while stack:
            node = stack.pop()
            if type(node) is tuple:
                if (len(node) == 2 and node[0] == "name"
                        and type(node[1]) is str):
                    names.add(node[1])
                else:
                    stack.extend(node)
            elif type(node) is list:
                stack.extend(node)
        out = frozenset(names)
        self._names_memo[id(block)] = (block, out)
        return out

    def _capture_env(self, scope: Scope, block) -> Scope:
        """Closure environment: a FLAT scope sharing only the cells of
        names the body mentions (Lua upvalue semantics, §3.5) — resolved
        eagerly at creation, so a local declared by the very statement
        that creates the closure is NOT visible inside it (matching
        Lua's visibility rule; `local function` pre-declares, which is
        exactly Lua's sugar). Unresolved names fall through to globals
        at call time. Capturing cells instead of the whole scope chain
        is also what lets an abandoned suspended coroutine be
        garbage-collected: its parked thread retains only the cells its
        body uses, not the sibling local holding the coroutine itself."""
        env = Scope()
        vars_ = env.vars
        for n in self._names_in(block):
            cell = scope.find_cell(n)
            if cell is not None:
                vars_[n] = cell
        return env

    # -- host API -----------------------------------------------------------
    def set_global(self, name: str, value) -> None:
        self.globals[name] = value

    def get_global(self, name: str):
        return self.globals.get(name)

    def execute(self, source: str) -> None:
        try:
            block = parse(source)
        except LuaSyntaxError as e:
            raise LuaError(str(e)) from None
        # the free-name memo is only consulted at closure CREATION; a
        # closure surviving this execution (or a suspended coroutine
        # resumed later) simply re-memoizes on demand. Clearing per
        # execute keeps a refresh-every-few-seconds session from
        # pinning every past script's ASTs forever.
        self._names_memo.clear()
        scope = Scope()
        scope.varargs = ()
        try:
            self._exec_block(block, scope)
        except _Return:
            pass
        except _Goto as g:
            raise LuaError(
                f"lua: line {g.line}: no visible label '{g.name}' for goto"
            ) from None

    # -- statement execution -------------------------------------------------
    def _exec_block(self, block: list, scope: Scope) -> None:
        i = 0
        while i < len(block):
            try:
                self._exec_stat(block[i], scope)
            except _Goto as g:
                for j, s in enumerate(block):
                    if s[0] == "label" and s[1] == g.name:
                        i = j  # land ON the label (a no-op), resume after
                        break
                else:
                    raise  # not ours — unwind to the enclosing block
            i += 1

    def _exec_stat(self, stat, scope: Scope) -> None:
        op = stat[0]
        if op == "callstat":
            self._eval_multi(stat[1], scope)
        elif op == "assign":
            targets, exprs = stat[1], stat[2]
            values = self._eval_list(exprs, scope, len(targets))
            for tgt, val in zip(targets, values):
                self._assign(tgt, val, scope)
        elif op == "local":
            names, exprs = stat[1], stat[2]
            values = self._eval_list(exprs, scope, len(names))
            for name, val in zip(names, values):
                scope.declare(name, val)
        elif op == "localfunc":
            name, fexpr = stat[1], stat[2]
            scope.declare(name, None)  # pre-declared so the body can recurse
            fn = self._eval(fexpr, scope)
            scope.vars[name].v = fn
        elif op == "if":
            for cond, blk in stat[1]:
                if _truthy(self._eval(cond, scope)):
                    self._exec_block(blk, Scope(scope))
                    return
            if stat[2] is not None:
                self._exec_block(stat[2], Scope(scope))
        elif op == "while":
            cond, blk = stat[1], stat[2]
            try:
                while _truthy(self._eval(cond, scope)):
                    self._exec_block(blk, Scope(scope))
            except _Break:
                pass
        elif op == "repeat":
            blk, cond = stat[1], stat[2]
            try:
                while True:
                    inner = Scope(scope)
                    self._exec_block(blk, inner)
                    # the until condition sees the loop body's locals
                    if _truthy(self._eval(cond, inner)):
                        break
            except _Break:
                pass
        elif op == "fornum":
            name, e1, e2, e3, blk = stat[1], stat[2], stat[3], stat[4], stat[5]
            start = _arith_operand(self._eval(e1, scope), "for")
            stop = _arith_operand(self._eval(e2, scope), "for")
            step = (
                _arith_operand(self._eval(e3, scope), "for")
                if e3 is not None
                else 1
            )
            if step == 0:
                raise LuaError("'for' step is zero")
            try:
                i = start
                while (step > 0 and i <= stop) or (step < 0 and i >= stop):
                    inner = Scope(scope)
                    inner.declare(name, i)
                    self._exec_block(blk, inner)
                    i += step
            except _Break:
                pass
        elif op == "forin":
            names, exprs, blk = stat[1], stat[2], stat[3]
            vals = self._eval_list(exprs, scope, 3)
            it, st, ctrl = vals[0], vals[1], vals[2]
            if it is None:
                raise LuaError("attempt to iterate a nil value")
            try:
                while True:
                    res = _as_tuple(_call(it, (st, ctrl)))
                    if not res or res[0] is None:
                        break
                    ctrl = res[0]
                    inner = Scope(scope)
                    for k, nm in enumerate(names):
                        inner.declare(nm, res[k] if k < len(res) else None)
                    self._exec_block(blk, inner)
            except _Break:
                pass
        elif op == "do":
            self._exec_block(stat[1], Scope(scope))
        elif op == "break":
            raise _Break()
        elif op == "label":
            pass  # jump target only; _exec_block resolves gotos onto it
        elif op == "goto":
            raise _Goto(stat[1], stat[2])
        elif op == "return":
            vals = self._eval_list_multi(stat[1], scope)
            raise _Return(tuple(vals))
        else:  # pragma: no cover
            raise LuaError(f"unknown statement {op!r}")

    def _index(self, obj, key):
        """Table/string indexing with __index metamethod fallback."""
        if isinstance(obj, LuaTable):
            v = obj.get(key)
            if v is not None:
                return v
            mi = obj.get_meta("__index")
            if mi is None:
                return None
            if isinstance(mi, LuaTable):
                return self._index(mi, key)
            res = _call(mi, (obj, key))
            if isinstance(res, tuple):
                return res[0] if res else None
            return res
        if isinstance(obj, str):
            strlib = self.globals.get("string")
            if isinstance(strlib, LuaTable):
                return strlib.get(key)
        raise LuaError(f"attempt to index a {lua_type(obj)} value")

    def _assign(self, target, value, scope: Scope) -> None:
        if target[0] == "name":
            name = target[1]
            cell = scope.find_cell(name)
            if cell is not None:
                cell.v = value
            else:
                self.globals[name] = value
        elif target[0] == "index":
            obj = self._eval(target[1], scope)
            key = self._eval(target[2], scope)
            if not isinstance(obj, LuaTable):
                raise LuaError(f"attempt to index a {lua_type(obj)} value")
            if obj.get(key) is None:
                mn = obj.get_meta("__newindex")
                if mn is not None:
                    if isinstance(mn, LuaTable):
                        mn.set(key, value)
                    else:
                        _call(mn, (obj, key, value))
                    return
            obj.set(key, value)
        else:  # pragma: no cover
            raise LuaError("invalid assignment target")

    # -- expression evaluation ------------------------------------------------
    def _eval_list(self, exprs, scope, want: int) -> list:
        """Evaluate an expression list, expanding the final multi-value
        expression, padded/truncated to `want` values."""
        vals = self._eval_list_multi(exprs, scope)
        if len(vals) < want:
            vals = vals + [None] * (want - len(vals))
        return vals[:want]

    def _eval_list_multi(self, exprs, scope) -> list:
        vals: list = []
        for i, e in enumerate(exprs):
            if i == len(exprs) - 1:
                vals.extend(_as_tuple(self._eval_multi(e, scope)))
            else:
                vals.append(self._eval(e, scope))
        return vals

    def _eval(self, expr, scope: Scope):
        """Evaluate to exactly one value."""
        v = self._eval_multi(expr, scope)
        if isinstance(v, tuple):
            return v[0] if v else None
        return v

    def _eval_multi(self, expr, scope: Scope):
        """Evaluate; calls/varargs may produce a tuple of values."""
        op = expr[0]
        if op == "num" or op == "str":
            return expr[1]
        if op == "nil":
            return None
        if op == "true":
            return True
        if op == "false":
            return False
        if op == "name":
            name = expr[1]
            s, v = scope.lookup(name)
            if s is not None:
                return v
            return self.globals.get(name)
        if op == "paren":
            return self._eval(expr[1], scope)
        if op == "index":
            obj = self._eval(expr[1], scope)
            key = self._eval(expr[2], scope)
            return self._index(obj, key)
        if op == "call":
            fn = self._eval(expr[1], scope)
            args = self._eval_list_multi(expr[2], scope)
            if isinstance(fn, LuaTable):
                meta_call = fn.get_meta("__call")
                if meta_call is not None:
                    return _call(meta_call, [fn] + args)
            return _call(fn, args)
        if op == "method":
            obj = self._eval(expr[1], scope)
            name = expr[2]
            fn = self._index(obj, name)
            args = self._eval_list_multi(expr[3], scope)
            return _call(fn, [obj] + args)
        if op == "vararg":
            return scope.find_varargs()
        if op == "func":
            return LuaFunction(
                expr[1], expr[2], expr[3],
                self._capture_env(scope, expr[3]), self,
            )
        if op == "table":
            t = LuaTable()
            array_exprs, hash_exprs = expr[1], expr[2]
            idx = 1
            for i, ae in enumerate(array_exprs):
                if i == len(array_exprs) - 1:
                    for v in _as_tuple(self._eval_multi(ae, scope)):
                        t.set(idx, v)
                        idx += 1
                else:
                    t.set(idx, self._eval(ae, scope))
                    idx += 1
            for ke, ve in hash_exprs:
                t.set(self._eval(ke, scope), self._eval(ve, scope))
            return t
        if op == "binop":
            return self._binop(expr[1], expr[2], expr[3], scope)
        if op == "unop":
            return self._unop(expr[1], expr[2], scope)
        raise LuaError(f"unknown expression {op!r}")  # pragma: no cover

    def _meta_bin(self, event: str, l, r):
        """Dispatch a binary metamethod (left operand's metatable wins,
        Lua 5.3 §2.4). Returns _MISSING when neither operand has one."""
        mm = l.get_meta(event) if isinstance(l, LuaTable) else None
        if mm is None and isinstance(r, LuaTable):
            mm = r.get_meta(event)
        if mm is None:
            return _MISSING
        res = _call(mm, (l, r))
        if isinstance(res, tuple):
            return res[0] if res else None
        return res

    def _binop(self, op, le, re, scope):
        if op == "and":
            l = self._eval(le, scope)
            return self._eval(re, scope) if _truthy(l) else l
        if op == "or":
            l = self._eval(le, scope)
            return l if _truthy(l) else self._eval(re, scope)
        l = self._eval(le, scope)
        r = self._eval(re, scope)
        if op == "..":
            if isinstance(l, (int, float, str)) and isinstance(r, (int, float, str)) \
                    and not isinstance(l, bool) and not isinstance(r, bool):
                return lua_tostring(l) + lua_tostring(r)
            res = self._meta_bin("__concat", l, r)
            if res is not _MISSING:
                return res
            raise LuaError(
                f"attempt to concatenate a {lua_type(r if isinstance(l, (int, float, str)) else l)} value"
            )
        if op in ("==", "~="):
            eq = _lua_eq(l, r)
            if (not eq and isinstance(l, LuaTable) and isinstance(r, LuaTable)):
                # __eq fires only when both are tables and raw-unequal
                res = self._meta_bin("__eq", l, r)
                if res is not _MISSING:
                    eq = _truthy(res)
            return eq if op == "==" else not eq
        if op in ("<", "<=", ">", ">="):
            if isinstance(l, str) and isinstance(r, str):
                pass
            elif (isinstance(l, (int, float)) and not isinstance(l, bool)
                  and isinstance(r, (int, float)) and not isinstance(r, bool)):
                pass
            else:
                # a > b is b < a, a >= b is b <= a (Lua 5.3 §3.4.4)
                event = "__lt" if op in ("<", ">") else "__le"
                a, b = (l, r) if op in ("<", "<=") else (r, l)
                res = self._meta_bin(event, a, b)
                if res is not _MISSING:
                    return _truthy(res)
                raise LuaError(
                    f"attempt to compare {lua_type(l)} with {lua_type(r)}"
                )
            if op == "<":
                return l < r
            if op == "<=":
                return l <= r
            if op == ">":
                return l > r
            return l >= r
        ln = _tonumber(l) if not isinstance(l, bool) else None
        rn = _tonumber(r) if not isinstance(r, bool) else None
        if ln is None or rn is None:
            res = self._meta_bin(_ARITH_EVENTS[op], l, r)
            if res is not _MISSING:
                return res
            _arith_operand(l if ln is None else r, op)  # raises with the type
        if op == "+":
            return ln + rn
        if op == "-":
            return ln - rn
        if op == "*":
            return ln * rn
        if op == "/":
            if rn == 0:
                if isinstance(ln, int) and isinstance(rn, int):
                    return math.inf if ln > 0 else (-math.inf if ln < 0 else math.nan)
            return float(ln) / float(rn) if rn != 0 else (
                math.inf if ln > 0 else (-math.inf if ln < 0 else math.nan))
        if op == "%":
            if rn == 0:
                if isinstance(ln, int) and isinstance(rn, int):
                    raise LuaError("attempt to perform 'n%%0'")
                return math.nan
            return ln - math.floor(ln / rn) * rn
        if op == "^":
            return float(ln) ** float(rn)
        if op == "//":
            if rn == 0:
                if isinstance(ln, int) and isinstance(rn, int):
                    raise LuaError("attempt to perform 'n//0'")
                return math.inf if ln > 0 else -math.inf
            res = math.floor(ln / rn)
            if isinstance(ln, float) or isinstance(rn, float):
                return float(res)
            return res
        if op in ("&", "|", "~", "<<", ">>"):
            li, ri = int(ln), int(rn)
            if op == "&":
                return li & ri
            if op == "|":
                return li | ri
            if op == "~":
                return li ^ ri
            if op == "<<":
                return (li << ri) & (2**64 - 1) if ri >= 0 else li >> -ri
            return li >> ri if ri >= 0 else li << -ri
        raise LuaError(f"unknown operator {op!r}")  # pragma: no cover

    def _unop(self, op, e, scope):
        v = self._eval(e, scope)
        if op == "-":
            if isinstance(v, LuaTable):
                res = self._meta_bin("__unm", v, v)
                if res is not _MISSING:
                    return res
            return -_arith_operand(v, "-")
        if op == "not":
            return not _truthy(v)
        if op == "#":
            if isinstance(v, str):
                return len(v)
            if isinstance(v, LuaTable):
                mm = v.get_meta("__len")
                if mm is not None:
                    res = _call(mm, (v,))
                    if isinstance(res, tuple):
                        return res[0] if res else None
                    return res
                return v.length()
            raise LuaError(f"attempt to get length of a {lua_type(v)} value")
        if op == "~":
            if isinstance(v, LuaTable):
                res = self._meta_bin("__bnot", v, v)
                if res is not _MISSING:
                    return res
            return ~int(_arith_operand(v, "~"))
        raise LuaError(f"unknown unary operator {op!r}")  # pragma: no cover


def _truthy(v) -> bool:
    return v is not None and v is not False


def _lua_eq(l, r) -> bool:
    if isinstance(l, bool) or isinstance(r, bool):
        return l is r
    if isinstance(l, (int, float)) and isinstance(r, (int, float)):
        return float(l) == float(r)
    if type(l) is not type(r) and not (
        isinstance(l, str) and isinstance(r, str)
    ):
        if l is None and r is None:
            return True
        if isinstance(l, LuaTable) and isinstance(r, LuaTable):
            return l is r
        return False
    if isinstance(l, LuaTable):
        return l is r
    return l == r


def _call(fn, args: list | tuple):
    if fn is None:
        raise LuaError("attempt to call a nil value")
    if not callable(fn):
        raise LuaError(f"attempt to call a {lua_type(fn)} value")
    try:
        return fn(*args)
    except (LuaError, _Return, _Break, _Goto):
        raise
    except RecursionError:
        raise LuaError("stack overflow") from None
    except (TypeError, ValueError, IndexError, KeyError, AttributeError,
            ZeroDivisionError, OverflowError) as e:
        # host/stdlib functions surface script misuse (wrong arg count,
        # bad types) as Python exceptions; mlua wraps every host error as
        # a Lua error (so pcall can trap it and refresh() aborts with
        # "Could not execute lua code!" instead of a raw traceback) —
        # mirror that at the one call boundary
        raise LuaError(f"{type(e).__name__}: {e}") from None


def _as_tuple(v) -> tuple:
    if isinstance(v, tuple):
        return v
    return (v,)
