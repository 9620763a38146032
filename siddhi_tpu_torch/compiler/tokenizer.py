"""SiddhiQL tokenizer.

Covers the lexical surface of the reference grammar
(reference: siddhi-query-compiler .../SiddhiQL.g4:500-913): case-insensitive
keywords (matched parser-side so keywords stay usable as names), `[a-zA-Z_]\\w*`
identifiers, backquoted identifiers, '/"/triple-quoted strings, numeric literals
with L/F/D suffixes and exponents, `--` and `/* */` comments, balanced-brace
SCRIPT bodies, and the operator/punctuation set including `->` and `...`.
"""

from __future__ import annotations

import dataclasses

from siddhi_tpu_torch.core.errors import SiddhiParserError


@dataclasses.dataclass
class Token:
    type: str  # ID, QID, INT, LONG, FLOAT, DOUBLE, STRING, SCRIPT, op text, EOF
    value: object
    line: int
    col: int

    @property
    def text(self) -> str:
        return "<end of input>" if self.type == "EOF" else str(self.value)


_PUNCT = [
    "...", "->", "<=", ">=", "==", "!=",
    ":", ";", ".", "(", ")", "[", "]", ",", "=", "*", "+", "?", "-", "/", "%",
    "<", ">", "@", "#", "!",
]


def tokenize(src: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(src)
    line, col = 1, 1

    def advance(k: int) -> None:
        nonlocal i, line, col
        for _ in range(k):
            if i < n and src[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    def err(msg: str) -> SiddhiParserError:
        return SiddhiParserError(msg, line, col)

    while i < n:
        c = src[i]
        # whitespace
        if c in " \t\r\n\x0b":
            advance(1)
            continue
        # comments
        if src.startswith("--", i):
            while i < n and src[i] != "\n":
                advance(1)
            continue
        if src.startswith("/*", i):
            end = src.find("*/", i + 2)
            stop = n if end < 0 else end + 2
            advance(stop - i)
            continue
        tl, tc = line, col
        # strings
        if src.startswith('"""', i):
            end = src.find('"""', i + 3)
            if end < 0:
                raise err("unterminated triple-quoted string")
            toks.append(Token("STRING", src[i + 3 : end], tl, tc))
            advance(end + 3 - i)
            continue
        if c in "'\"":
            j = i + 1
            while j < n and src[j] != c:
                if src[j] == "\n":
                    raise err("unterminated string literal")
                j += 1
            if j >= n:
                raise err("unterminated string literal")
            toks.append(Token("STRING", src[i + 1 : j], tl, tc))
            advance(j + 1 - i)
            continue
        # backquoted identifier
        if c == "`":
            j = src.find("`", i + 1)
            if j < 0:
                raise err("unterminated quoted identifier")
            toks.append(Token("QID", src[i + 1 : j], tl, tc))
            advance(j + 1 - i)
            continue
        # script body { ... } with balanced braces
        if c == "{":
            depth, j = 0, i
            while j < n:
                if src[j] == "{":
                    depth += 1
                elif src[j] == "}":
                    depth -= 1
                    if depth == 0:
                        break
                elif src[j] in "'\"":
                    q = src[j]
                    j += 1
                    while j < n and src[j] != q:
                        j += 1
                j += 1
            if depth != 0:
                raise err("unbalanced '{' in script body")
            toks.append(Token("SCRIPT", src[i + 1 : j], tl, tc))
            advance(j + 1 - i)
            continue
        # numbers (a leading '.' digit form too)
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                ch = src[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    # '...' (aggregation range) must not be eaten by a number
                    if src.startswith("...", j):
                        break
                    # require digit or end-ish after '.': '1.sec'? reference
                    # FLOAT allows '1.'; keep permissive unless followed by '.'
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                    src[j + 1].isdigit() or (src[j + 1] in "+-" and j + 2 < n and src[j + 2].isdigit())
                ):
                    seen_exp = True
                    j += 1
                    if src[j] in "+-":
                        j += 1
                else:
                    break
            body = src[i:j]
            suffix = src[j].upper() if j < n and src[j].upper() in ("L", "F", "D") else ""
            # a suffix letter must not begin a longer identifier (e.g. `5 days`
            # lexes INT(5) ID(days), but `5L` is LONG) — except that `10f`/`10d`
            # glued to an id char is invalid anyway
            if suffix and (j + 1 >= n or not (src[j + 1].isalnum() or src[j + 1] == "_")):
                j += 1
            else:
                suffix = ""
            if suffix == "L":
                if seen_dot or seen_exp:
                    raise err(f"invalid long literal {body + 'L'!r}")
                toks.append(Token("LONG", int(body), tl, tc))
            elif suffix == "F":
                toks.append(Token("FLOAT", float(body), tl, tc))
            elif suffix == "D":
                toks.append(Token("DOUBLE", float(body), tl, tc))
            elif seen_dot or seen_exp:
                toks.append(Token("DOUBLE", float(body), tl, tc))
            else:
                toks.append(Token("INT", int(body), tl, tc))
            advance(j - i)
            continue
        # identifiers
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            toks.append(Token("ID", src[i:j], tl, tc))
            advance(j - i)
            continue
        # punctuation / operators
        for p in _PUNCT:
            if src.startswith(p, i):
                toks.append(Token(p, p, tl, tc))
                advance(len(p))
                break
        else:
            raise err(f"unexpected character {c!r}")
    toks.append(Token("EOF", None, line, col))
    return toks


# time units (singular/plural/abbreviated) -> milliseconds
# (reference: SiddhiQL.g4 time_value / YEARS..MILLISECONDS token rules)
TIME_UNITS = {
    "year": 365 * 86_400_000, "years": 365 * 86_400_000,
    "month": 30 * 86_400_000, "months": 30 * 86_400_000,
    "week": 7 * 86_400_000, "weeks": 7 * 86_400_000,
    "day": 86_400_000, "days": 86_400_000,
    "hour": 3_600_000, "hours": 3_600_000,
    "min": 60_000, "minute": 60_000, "minutes": 60_000,
    "sec": 1_000, "second": 1_000, "seconds": 1_000,
    "millisec": 1, "millisecond": 1, "milliseconds": 1,
}
