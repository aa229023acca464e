"""Carried over from termdaw_tpu/lua/parser.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

Lua parser: token stream -> AST.

AST nodes are plain tuples tagged by their first element:

expressions:
    ("nil",) ("true",) ("false",) ("vararg",)
    ("num", value) ("str", value)
    ("name", name)
    ("index", obj_expr, key_expr)
    ("call", fn_expr, [arg_exprs])
    ("method", obj_expr, name, [arg_exprs])
    ("func", [param_names], is_vararg, block)
    ("binop", op, lhs, rhs) ("unop", op, expr)
    ("table", [array_exprs], [(key_expr, val_expr)])

statements:
    ("assign", [target_exprs], [value_exprs])
    ("local", [names], [value_exprs])
    ("callstat", call_expr)
    ("do", block)
    ("while", cond, block)
    ("repeat", block, cond)
    ("if", [(cond, block), ...], else_block_or_None)
    ("fornum", name, start, stop, step_or_None, block)
    ("forin", [names], [exprs], block)
    ("localfunc", name, func_expr)
    ("break",)
    ("return", [exprs])

A block is a list of statements.
"""

from __future__ import annotations

from .lexer import Token, tokenize, LuaSyntaxError


# binary operator precedence (left, right); right > left means right-assoc
_BINPREC = {
    "or": (1, 1), "and": (2, 2),
    "<": (3, 3), ">": (3, 3), "<=": (3, 3), ">=": (3, 3), "~=": (3, 3), "==": (3, 3),
    "|": (4, 4), "~": (5, 5), "&": (6, 6),
    "<<": (7, 7), ">>": (7, 7),
    "..": (9, 8),  # right associative
    "+": (10, 10), "-": (10, 10),
    "*": (11, 11), "/": (11, 11), "//": (11, 11), "%": (11, 11),
    "^": (14, 13),  # right associative
}
_UNARY_PREC = 12


class Parser:
    def __init__(self, toks: list[Token]):
        self.toks = toks
        self.pos = 0

    # -- token helpers -----------------------------------------------------
    def peek(self) -> Token:
        return self.toks[self.pos]

    def next(self) -> Token:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def check(self, kind: str, value=None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def accept(self, kind: str, value=None) -> Token | None:
        if self.check(kind, value):
            return self.next()
        return None

    def expect(self, kind: str, value=None) -> Token:
        t = self.peek()
        if not self.check(kind, value):
            want = value if value is not None else kind
            got = "end of file" if t.kind == "eof" else repr(t.value)
            raise LuaSyntaxError(
                f"lua: line {t.line}: expected {want!r}, got {got}"
            )
        return self.next()

    # -- blocks and statements ---------------------------------------------
    def parse_chunk(self) -> list:
        block = self.parse_block()
        if not self.check("eof"):
            t = self.peek()
            raise LuaSyntaxError(f"lua: line {t.line}: unexpected {t.value!r}")
        return block

    def _block_ends(self) -> bool:
        t = self.peek()
        return t.kind == "eof" or (
            t.kind == "keyword" and t.value in ("end", "else", "elseif", "until")
        )

    def parse_block(self) -> list:
        stats = []
        while not self._block_ends():
            if self.accept("keyword", "return"):
                exprs = []
                if not self._block_ends() and not self.check("symbol", ";"):
                    exprs = self.parse_exprlist()
                self.accept("symbol", ";")
                stats.append(("return", exprs))
                break
            s = self.parse_statement()
            if s is not None:
                stats.append(s)
        return stats

    def parse_statement(self):
        if self.accept("symbol", ";"):
            return None
        t = self.peek()
        if t.kind == "keyword":
            kw = t.value
            if kw == "break":
                self.next()
                return ("break",)
            if kw == "do":
                self.next()
                block = self.parse_block()
                self.expect("keyword", "end")
                return ("do", block)
            if kw == "while":
                self.next()
                cond = self.parse_expr()
                self.expect("keyword", "do")
                block = self.parse_block()
                self.expect("keyword", "end")
                return ("while", cond, block)
            if kw == "repeat":
                self.next()
                block = self.parse_block()
                self.expect("keyword", "until")
                cond = self.parse_expr()
                return ("repeat", block, cond)
            if kw == "if":
                return self.parse_if()
            if kw == "for":
                return self.parse_for()
            if kw == "function":
                self.next()
                return self.parse_function_stat()
            if kw == "local":
                self.next()
                if self.accept("keyword", "function"):
                    name = self.expect("name").value
                    fn = self.parse_funcbody()
                    return ("localfunc", name, fn)
                names = [self.expect("name").value]
                while self.accept("symbol", ","):
                    names.append(self.expect("name").value)
                exprs = []
                if self.accept("symbol", "="):
                    exprs = self.parse_exprlist()
                return ("local", names, exprs)
            if kw == "goto":
                self.next()
                name = self.expect("name").value
                return ("goto", name, t.line)
            raise LuaSyntaxError(f"lua: line {t.line}: unexpected keyword {kw!r}")

        if t.kind == "symbol" and t.value == "::":
            self.next()
            name = self.expect("name").value
            self.expect("symbol", "::")
            return ("label", name)

        # expression statement: assignment or call
        e = self.parse_suffixed()
        if self.check("symbol", "=") or self.check("symbol", ","):
            targets = [e]
            while self.accept("symbol", ","):
                targets.append(self.parse_suffixed())
            self.expect("symbol", "=")
            exprs = self.parse_exprlist()
            for tgt in targets:
                if tgt[0] not in ("name", "index"):
                    raise LuaSyntaxError(
                        f"lua: line {t.line}: cannot assign to this expression"
                    )
            return ("assign", targets, exprs)
        if e[0] not in ("call", "method"):
            raise LuaSyntaxError(f"lua: line {t.line}: syntax error near {t.value!r}")
        return ("callstat", e)

    def parse_if(self):
        self.expect("keyword", "if")
        arms = []
        cond = self.parse_expr()
        self.expect("keyword", "then")
        arms.append((cond, self.parse_block()))
        else_block = None
        while True:
            if self.accept("keyword", "elseif"):
                c = self.parse_expr()
                self.expect("keyword", "then")
                arms.append((c, self.parse_block()))
            elif self.accept("keyword", "else"):
                else_block = self.parse_block()
                self.expect("keyword", "end")
                break
            else:
                self.expect("keyword", "end")
                break
        return ("if", arms, else_block)

    def parse_for(self):
        self.expect("keyword", "for")
        name = self.expect("name").value
        if self.accept("symbol", "="):
            start = self.parse_expr()
            self.expect("symbol", ",")
            stop = self.parse_expr()
            step = None
            if self.accept("symbol", ","):
                step = self.parse_expr()
            self.expect("keyword", "do")
            block = self.parse_block()
            self.expect("keyword", "end")
            return ("fornum", name, start, stop, step, block)
        names = [name]
        while self.accept("symbol", ","):
            names.append(self.expect("name").value)
        self.expect("keyword", "in")
        exprs = self.parse_exprlist()
        self.expect("keyword", "do")
        block = self.parse_block()
        self.expect("keyword", "end")
        return ("forin", names, exprs, block)

    def parse_function_stat(self):
        # funcname: Name {'.' Name} [':' Name]
        target: tuple = ("name", self.expect("name").value)
        is_method = False
        while True:
            if self.accept("symbol", "."):
                target = ("index", target, ("str", self.expect("name").value))
            elif self.accept("symbol", ":"):
                target = ("index", target, ("str", self.expect("name").value))
                is_method = True
                break
            else:
                break
        fn = self.parse_funcbody(implicit_self=is_method)
        return ("assign", [target], [fn])

    def parse_funcbody(self, implicit_self: bool = False):
        self.expect("symbol", "(")
        params = ["self"] if implicit_self else []
        is_vararg = False
        if not self.check("symbol", ")"):
            while True:
                if self.accept("symbol", "..."):
                    is_vararg = True
                    break
                params.append(self.expect("name").value)
                if not self.accept("symbol", ","):
                    break
        self.expect("symbol", ")")
        block = self.parse_block()
        self.expect("keyword", "end")
        return ("func", params, is_vararg, block)

    # -- expressions --------------------------------------------------------
    def parse_exprlist(self) -> list:
        exprs = [self.parse_expr()]
        while self.accept("symbol", ","):
            exprs.append(self.parse_expr())
        return exprs

    def parse_expr(self, limit: int = 0):
        t = self.peek()
        if (t.kind == "symbol" and t.value in ("-", "#", "~")) or (
            t.kind == "keyword" and t.value == "not"
        ):
            op = self.next().value
            operand = self.parse_expr(_UNARY_PREC)
            left = ("unop", op, operand)
        else:
            left = self.parse_simple()
        while True:
            t = self.peek()
            op = None
            if t.kind == "symbol" and t.value in _BINPREC:
                op = t.value
            elif t.kind == "keyword" and t.value in ("and", "or"):
                op = t.value
            if op is None:
                break
            lprec, rprec = _BINPREC[op]
            if lprec <= limit:
                break
            self.next()
            right = self.parse_expr(rprec)
            left = ("binop", op, left, right)
        return left

    def parse_simple(self):
        t = self.peek()
        if t.kind == "number":
            self.next()
            return ("num", t.value)
        if t.kind == "string":
            self.next()
            return ("str", t.value)
        if t.kind == "keyword":
            if t.value == "nil":
                self.next()
                return ("nil",)
            if t.value == "true":
                self.next()
                return ("true",)
            if t.value == "false":
                self.next()
                return ("false",)
            if t.value == "function":
                self.next()
                return self.parse_funcbody()
        if t.kind == "symbol":
            if t.value == "...":
                self.next()
                return ("vararg",)
            if t.value == "{":
                return self.parse_table()
        return self.parse_suffixed()

    def parse_table(self):
        self.expect("symbol", "{")
        array = []
        hash_items = []
        while not self.check("symbol", "}"):
            if self.check("symbol", "["):
                self.next()
                key = self.parse_expr()
                self.expect("symbol", "]")
                self.expect("symbol", "=")
                hash_items.append((key, self.parse_expr()))
            elif self.check("name") and self.toks[self.pos + 1].kind == "symbol" \
                    and self.toks[self.pos + 1].value == "=":
                key = ("str", self.next().value)
                self.next()  # '='
                hash_items.append((key, self.parse_expr()))
            else:
                array.append(self.parse_expr())
            if not (self.accept("symbol", ",") or self.accept("symbol", ";")):
                break
        self.expect("symbol", "}")
        return ("table", array, hash_items)

    def parse_suffixed(self):
        t = self.peek()
        if t.kind == "name":
            self.next()
            e: tuple = ("name", t.value)
        elif self.accept("symbol", "("):
            inner = self.parse_expr()
            self.expect("symbol", ")")
            # parenthesized expressions truncate multiple returns to one
            e = ("paren", inner)
        else:
            got = "end of file" if t.kind == "eof" else repr(t.value)
            raise LuaSyntaxError(
                f"lua: line {t.line}: unexpected {got} in expression"
            )
        while True:
            if self.accept("symbol", "."):
                name = self.expect("name").value
                e = ("index", e, ("str", name))
            elif self.accept("symbol", "["):
                key = self.parse_expr()
                self.expect("symbol", "]")
                e = ("index", e, key)
            elif self.check("symbol", ":") and self.toks[self.pos + 1].kind == "name":
                self.next()
                name = self.expect("name").value
                args = self.parse_args()
                e = ("method", e, name, args)
            elif self.check("symbol", "(") or self.check("string") or self.check(
                "symbol", "{"
            ):
                args = self.parse_args()
                e = ("call", e, args)
            else:
                break
        return e

    def parse_args(self) -> list:
        if self.check("string"):
            return [("str", self.next().value)]
        if self.check("symbol", "{"):
            return [self.parse_table()]
        self.expect("symbol", "(")
        args = []
        if not self.check("symbol", ")"):
            args = self.parse_exprlist()
        self.expect("symbol", ")")
        return args


def parse(src: str) -> list:
    return Parser(tokenize(src)).parse_chunk()
