"""A small Fortran namelist reader for the benchmark's plain reference.

It reads the frozen namelist copies under ``benchmark/configs/`` and
nothing else, so it handles only what they use: groups ``&name ... /``,
``key=value`` pairs separated by commas or newlines, indexed keys
``t0s(0)=5.0e3``, repeats ``2*'zero'``, quoted strings, ``.true.`` and
``.false.``, numbers with ``e`` or ``d`` exponents, and ``!`` comments.

Returns ``{group: {key: value}}`` with names lower-cased; an indexed key
becomes ``{index: value}``, a key with several values a list.
"""

from __future__ import annotations

import re

_PAIR = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*(?:\(\s*(-?\d+)\s*\))?\s*=")


def _value(tok):
    tok = tok.strip()
    if tok.startswith("'"):
        return tok[1:-1]
    low = tok.lower()
    if low in (".true.", ".t."):
        return True
    if low in (".false.", ".f."):
        return False
    num = low.replace("d", "e")
    try:
        return int(num)
    except ValueError:
        return float(num)


def _values(text):
    """The values of one assignment's right-hand side, repeats expanded."""
    out = []
    for tok in re.findall(r"'[^']*'|[^,\s]+", text):
        m = re.match(r"^(\d+)\*(.+)$", tok)
        if m and not tok.startswith("'"):
            out.extend([_value(m.group(2))] * int(m.group(1)))
        else:
            out.append(_value(tok))
    return out


def parse(text):
    lines = []
    for line in text.splitlines():
        quoted = False
        for i, ch in enumerate(line):
            if ch == "'":
                quoted = not quoted
            elif ch == "!" and not quoted:
                line = line[:i]
                break
        lines.append(line)
    body = "\n".join(lines)
    groups = {}
    for m in re.finditer(r"&(\w+)(.*?)^\s*/", body, re.S | re.M):
        name, content = m.group(1).lower(), m.group(2)
        group = groups.setdefault(name, {})
        pairs = list(_PAIR.finditer(content))
        for i, p in enumerate(pairs):
            end = pairs[i + 1].start() if i + 1 < len(pairs) else len(content)
            vals = _values(content[p.end():end])
            key = p.group(1).lower()
            if p.group(2) is not None:
                group.setdefault(key, {})[int(p.group(2))] = vals[0]
            else:
                group[key] = vals[0] if len(vals) == 1 else vals
    return groups
