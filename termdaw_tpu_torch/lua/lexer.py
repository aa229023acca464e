"""Carried over from termdaw_tpu/lua/lexer.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

Lua lexer: source text -> token stream."""

from __future__ import annotations

from dataclasses import dataclass


class LuaSyntaxError(SyntaxError):
    pass


KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for", "function",
    "goto", "if", "in", "local", "nil", "not", "or", "repeat", "return",
    "then", "true", "until", "while",
}

# Multi-char symbols, longest first.
SYMBOLS = [
    "...", "..", ".",
    "==", "~=", "<=", ">=", "<<", ">>", "//",
    "=", "<", ">", "+", "-", "*", "/", "%", "^", "#", "&", "~", "|",
    "(", ")", "{", "}", "[", "]", ";", ":", ",", "::",
]
SYMBOLS.sort(key=len, reverse=True)


@dataclass
class Token:
    kind: str  # "name" | "number" | "string" | "keyword" | "symbol" | "eof"
    value: object
    line: int


_ESCAPES = {
    "a": "\a", "b": "\b", "f": "\f", "n": "\n", "r": "\r",
    "t": "\t", "v": "\v", "\\": "\\", '"': '"', "'": "'", "\n": "\n",
}


def tokenize(src: str) -> list[Token]:
    toks: list[Token] = []
    i = 0
    n = len(src)
    line = 1

    def err(msg: str):
        raise LuaSyntaxError(f"lua: line {line}: {msg}")

    def long_bracket(start: int) -> tuple[str, int] | None:
        """Parse a [[...]] / [=[...]=] long bracket starting at `start`.
        Returns (content, end_index) or None if not a long bracket."""
        j = start
        if src[j] != "[":
            return None
        j += 1
        level = 0
        while j < n and src[j] == "=":
            level += 1
            j += 1
        if j >= n or src[j] != "[":
            return None
        j += 1
        if j < n and src[j] == "\n":
            j += 1  # skip leading newline, per Lua
        close = "]" + "=" * level + "]"
        end = src.find(close, j)
        if end < 0:
            err("unterminated long bracket")
        return src[j:end], end + len(close)

    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        # comments
        if src.startswith("--", i):
            lb = long_bracket(i + 2) if i + 2 < n and src[i + 2] == "[" else None
            if lb is not None:
                content, i = lb
                line += content.count("\n")
                continue
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        # long string
        if c == "[" and i + 1 < n and src[i + 1] in "[=":
            lb = long_bracket(i)
            if lb is not None:
                content, i2 = lb
                toks.append(Token("string", content, line))
                line += content.count("\n")
                i = i2
                continue
        # strings
        if c in "\"'":
            quote = c
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    err("unterminated string")
                ch = src[j]
                if ch == quote:
                    j += 1
                    break
                if ch == "\n":
                    err("unterminated string")
                if ch == "\\":
                    j += 1
                    if j >= n:
                        err("unterminated string escape")
                    e = src[j]
                    if e in _ESCAPES:
                        buf.append(_ESCAPES[e])
                        if e == "\n":
                            line += 1
                        j += 1
                    elif e == "x":
                        try:
                            buf.append(chr(int(src[j + 1 : j + 3], 16)))
                        except ValueError:
                            err("hexadecimal digit expected")
                        j += 3
                    elif e.isdigit():
                        k = j
                        while k < n and k < j + 3 and src[k].isdigit():
                            k += 1
                        code = int(src[j:k])
                        if code > 255:
                            err("decimal escape too large")
                        buf.append(chr(code))
                        j = k
                    elif e == "z":
                        j += 1
                        while j < n and src[j] in " \t\r\n":
                            if src[j] == "\n":
                                line += 1
                            j += 1
                    else:
                        err(f"invalid escape '\\{e}'")
                else:
                    buf.append(ch)
                    j += 1
            toks.append(Token("string", "".join(buf), line))
            i = j
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            is_hex = src.startswith("0x", i) or src.startswith("0X", i)
            if is_hex:
                j = i + 2
                while j < n and (src[j] in "0123456789abcdefABCDEF.pP" or
                                 (src[j] in "+-" and src[j - 1] in "pP")):
                    j += 1
                text = src[i:j]
                try:
                    val: object = int(text, 16)
                except ValueError:
                    try:
                        val = float.fromhex(text)
                    except ValueError:
                        err(f"malformed number near '{text}'")
            else:
                while j < n and (src[j].isdigit() or src[j] in ".eE" or
                                 (src[j] in "+-" and src[j - 1] in "eE")):
                    j += 1
                text = src[i:j]
                try:
                    if "." in text or "e" in text or "E" in text:
                        val = float(text)
                    else:
                        val = int(text)
                except ValueError:
                    # '1e', '1..2', '1e+' etc. must be a SYNTAX error the
                    # runtime converts to LuaError, not a raw ValueError
                    # that crashes refresh()
                    err(f"malformed number near '{text}'")
            toks.append(Token("number", val, line))
            i = j
            continue
        # names / keywords
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            if word in KEYWORDS:
                toks.append(Token("keyword", word, line))
            else:
                toks.append(Token("name", word, line))
            i = j
            continue
        # symbols
        for sym in SYMBOLS:
            if src.startswith(sym, i):
                toks.append(Token("symbol", sym, line))
                i += len(sym)
                break
        else:
            err(f"unexpected character {c!r}")

    toks.append(Token("eof", None, line))
    return toks
