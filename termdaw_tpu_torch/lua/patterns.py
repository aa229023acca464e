"""Carried over from termdaw_tpu/lua/patterns.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

Lua pattern matching (string.find/match/gmatch/gsub).

Implements the practical core of Lua 5.3 patterns by translation to Python
regexes: character classes (%a %d %l %s %u %w %x %p %c and complements),
sets [...], quantifiers (* + - ?), anchors (^ $), captures, %b balanced
match is NOT supported (rare; raises), and %1-style back-references in
patterns are unsupported (gsub replacement %1..%9 ARE supported).
"""

from __future__ import annotations

import re

_CLASS_MAP = {
    "a": "[a-zA-Z]", "A": "[^a-zA-Z]",
    "d": "[0-9]", "D": "[^0-9]",
    "l": "[a-z]", "L": "[^a-z]",
    "s": "[ \\t\\n\\r\\f\\v]", "S": "[^ \\t\\n\\r\\f\\v]",
    "u": "[A-Z]", "U": "[^A-Z]",
    "w": "[a-zA-Z0-9]", "W": "[^a-zA-Z0-9]",
    "x": "[0-9a-fA-F]", "X": "[^0-9a-fA-F]",
    "p": "[\\!-/\\:-@\\[-`\\{-~]", "P": "[^\\!-/\\:-@\\[-`\\{-~]",
    "c": "[\\x00-\\x1f]", "C": "[^\\x00-\\x1f]",
}

_CLASS_INNER = {  # inside [...] sets: no surrounding brackets
    "a": "a-zA-Z", "d": "0-9", "l": "a-z", "s": " \\t\\n\\r\\f\\v",
    "u": "A-Z", "w": "a-zA-Z0-9", "x": "0-9a-fA-F",
    "p": "\\!-/\\:-@\\[-`\\{-~", "c": "\\x00-\\x1f",
}


class LuaPatternError(ValueError):
    pass


def translate(pat: str) -> str:
    """Lua pattern -> Python regex source ('^' anchor becomes Python '^',
    i.e. position-0 only — right for gsub/gmatch; find/match use
    _compile_floating so the anchor works at any init offset)."""
    if pat.startswith("^"):
        return "^" + _translate_body(pat[1:])
    return _translate_body(pat)


def _translate_body(pat: str) -> str:
    out = []
    i = 0
    n = len(pat)
    while i < n:
        c = pat[i]
        if c == "%":
            i += 1
            if i >= n:
                raise LuaPatternError("malformed pattern (ends with '%')")
            e = pat[i]
            if e in _CLASS_MAP:
                out.append(_CLASS_MAP[e])
            elif e == "b":
                raise LuaPatternError("%b balanced match is not supported")
            elif e == "f":
                raise LuaPatternError("%f frontier is not supported")
            elif e.isdigit():
                raise LuaPatternError("pattern back-references not supported")
            else:
                out.append(re.escape(e))
            i += 1
        elif c == "[":
            j = i + 1
            neg = False
            if j < n and pat[j] == "^":
                neg = True
                j += 1
            inner = []       # plain set contents
            comps = []       # complement classes (%S, %W, ...) in the set
            first = True
            while j < n and (pat[j] != "]" or first):
                first = False
                if pat[j] == "%" and j + 1 < n:
                    e = pat[j + 1]
                    if e.islower() and e in _CLASS_INNER:
                        inner.append(_CLASS_INNER[e])
                    elif e.isupper() and e.lower() in _CLASS_INNER:
                        # complement class inside a set ([%Sx]): cannot be
                        # expressed inside a Python character class
                        # (previously matched the LITERAL letter) — pull
                        # it out and union via alternation below
                        comps.append(_CLASS_MAP[e])
                    else:
                        inner.append(re.escape(e))
                    j += 2
                else:
                    ch = pat[j]
                    if ch in "\\^]":
                        inner.append("\\" + ch)
                    elif ch == "-" and j + 1 < n and pat[j + 1] != "]" \
                            and inner:
                        inner.append("-")
                    else:
                        inner.append(re.escape(ch) if ch in "[]" else ch)
                    j += 1
            if j >= n:
                raise LuaPatternError("malformed pattern (missing ']')")
            if comps:
                atoms = list(comps)
                if inner:
                    atoms.append("[" + "".join(inner) + "]")
                union = "(?:" + "|".join(atoms) + ")"
                # [^...] with complement members = NOT(union): one char
                # that doesn't start the union (DOTALL '.' = any char)
                out.append(f"(?:(?!{union}).)" if neg else union)
            else:
                out.append("[" + ("^" if neg else "") + "".join(inner) + "]")
            i = j + 1
        elif c == ".":
            out.append(".")
            i += 1
        elif c in "()":
            out.append(c)
            i += 1
        elif c == "$" and i == n - 1:
            out.append("$")
            i += 1
        elif c in "*+?":
            out.append(c)
            i += 1
        elif c == "-":
            # lazy zero-or-more applies to the previous atom
            out.append("*?")
            i += 1
        else:
            out.append(re.escape(c))
            i += 1
    return "".join(out)


def _compile_src(src: str) -> re.Pattern:
    try:
        return re.compile(src, re.DOTALL)
    except re.error as e:
        # '*a' and friends are legal-looking Lua that Python rejects —
        # must surface as a Lua pattern error, not a raw re.error that
        # escapes the LuaError boundary and crashes refresh()
        raise LuaPatternError(f"malformed pattern ({e})") from None


def _compile(pat: str) -> re.Pattern:
    return _compile_src(translate(pat))


def _compile_floating(pat: str) -> tuple[re.Pattern, bool]:
    """For find/match: Lua's '^' anchors at the INIT offset, which Python
    '^' cannot do — strip it and use Pattern.match(s, pos) instead."""
    anchored = pat.startswith("^")
    return _compile_src(_translate_body(pat[1:] if anchored else pat)), \
        anchored


def _caps(m: re.Match):
    if m.re.groups == 0:
        return (m.group(0),)
    return m.groups()


def lua_find(s: str, pat: str, init: int = 1, plain=False):
    start = max(int(init) - 1, 0) if init >= 0 else max(len(s) + int(init), 0)
    if plain:
        idx = s.find(pat, start)
        if idx < 0:
            return (None,)
        return (idx + 1, idx + len(pat))
    rx, anchored = _compile_floating(pat)
    m = rx.match(s, start) if anchored else rx.search(s, start)
    if m is None:
        return (None,)
    res = [m.start() + 1, m.end()]
    if m.re.groups:
        res.extend(m.groups())
    return tuple(res)


def lua_match(s: str, pat: str, init: int = 1):
    start = max(int(init) - 1, 0) if init >= 0 else max(len(s) + int(init), 0)
    rx, anchored = _compile_floating(pat)
    m = rx.match(s, start) if anchored else rx.search(s, start)
    if m is None:
        return (None,)
    return _caps(m)


def lua_gmatch(s: str, pat: str):
    rx = _compile(pat)
    it = rx.finditer(s)

    def iterator(*_args):
        for m in it:
            return _caps(m)
        return (None,)

    return iterator


def lua_gsub(s: str, pat: str, repl, max_n=None):
    rx = _compile(pat)
    count = 0
    out = []
    pos = 0
    for m in rx.finditer(s):
        if max_n is not None and count >= int(max_n):
            break
        out.append(s[pos : m.start()])
        caps = _caps(m)
        if isinstance(repl, str):
            rep = []
            k = 0
            while k < len(repl):
                if repl[k] == "%" and k + 1 < len(repl):
                    d = repl[k + 1]
                    if d == "0":
                        rep.append(m.group(0))
                    elif d.isdigit():
                        gi = int(d)
                        rep.append(str(caps[gi - 1]) if gi <= len(caps) else "")
                    else:
                        rep.append(d)
                    k += 2
                else:
                    rep.append(repl[k])
                    k += 1
            out.append("".join(rep))
        elif callable(repl):
            r = repl(*caps)
            if isinstance(r, tuple):
                r = r[0] if r else None
            out.append(str(r) if r is not None and r is not False
                       else m.group(0))
        else:
            # table replacement
            key = caps[0]
            v = repl.get(key) if hasattr(repl, "get") else None
            out.append(str(v) if v is not None and v is not False
                       else m.group(0))
        pos = m.end()
        count += 1
        if m.start() == m.end():  # avoid infinite empty-match loops
            if pos < len(s):
                out.append(s[pos])
                pos += 1
            else:
                break
    out.append(s[pos:])
    return ("".join(out), count)
