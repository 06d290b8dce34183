"""Fortran namelist reader.

The reference configures every module from namelist groups in a single
``rays.in`` file (catalog: reference RAYS_project/RAYS_lib/
namelist_description.md).  This importer lets the committed example inputs
drive rays_tpu unchanged.  It handles the quirks those files actually use:

* groups ``&name ... /``
* scalar and array assignments, including indexed ones ``t0s(0)=5.0e3``
* repeat counts ``t_prof_model=2*'zero'``
* Fortran logicals ``.true.``/``.false.``, single-quoted strings,
  ``d``/``D`` exponents
* ``!`` comments, values continued across lines, trailing junk after the
  final ``/`` (e.g. the ``NSTX`` tag in the slab example input)

Returns ``{group_name: {key: value}}`` where an indexed assignment becomes a
dict ``{index: value}`` under the key, and multi-value assignments become
lists.  Group and key names are lower-cased (namelists are
case-insensitive).
"""

from __future__ import annotations

import re

_TOKEN_RE = re.compile(
    r"""
    '(?:[^']|'')*'            # quoted string (doubled '' = escaped quote)
  | \.(?:true|false|t|f)\.    # logical
  | [A-Za-z_][A-Za-z0-9_]*(?:\([^)]*\))?\s*= # key= (optionally indexed)
  | [^\s,]+                   # bare value token
    """,
    re.VERBOSE | re.IGNORECASE,
)

_NUM_RE = re.compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?$"
)
_INT_RE = re.compile(r"^[+-]?\d+$")
_REPEAT_RE = re.compile(r"^(\d+)\*(.*)$")


def _strip_comments(line: str) -> str:
    out = []
    in_str = False
    for ch in line:
        if ch == "'":
            in_str = not in_str
        if ch == "!" and not in_str:
            break
        out.append(ch)
    return "".join(out)


def _convert(tok: str):
    """Convert one Fortran value token to a Python value."""
    t = tok.strip()
    if t.startswith("'"):
        return t[1:-1].replace("''", "'")
    low = t.lower()
    if low in (".true.", ".t.", "t", ".true"):
        return True
    if low in (".false.", ".f.", "f", ".false"):
        return False
    if _INT_RE.match(t):
        return int(t)
    if _NUM_RE.match(t):
        return float(t.lower().replace("d", "e"))
    return t  # bare string (namelists allow unquoted strings rarely; keep)


def _expand(tokens):
    """Expand repeat-count tokens like 2*'zero' into individual values."""
    vals = []
    for tok in tokens:
        m = _REPEAT_RE.match(tok)
        if m and not tok.startswith("'"):
            count, val = int(m.group(1)), m.group(2)
            vals.extend([_convert(val)] * count)
        else:
            vals.append(_convert(tok))
    return vals


def parse_namelist(text: str) -> dict:
    groups: dict[str, dict] = {}
    cur: dict | None = None

    # Tokenize line by line to respect comments; accumulate assignments.
    pending_key = None   # (name, index or None)
    pending_vals: list[str] = []

    def flush():
        nonlocal pending_key, pending_vals
        if cur is None or pending_key is None:
            pending_key, pending_vals = None, []
            return
        name, index = pending_key
        vals = _expand(pending_vals)
        value = vals[0] if len(vals) == 1 else vals
        if index is not None:
            slot = cur.setdefault(name, {})
            if not isinstance(slot, dict):
                slot = {None: slot}
                cur[name] = slot
            if isinstance(value, list):
                for off, v in enumerate(value):
                    slot[index + off] = v
            else:
                slot[index] = value
        else:
            cur[name] = value
        pending_key, pending_vals = None, []

    for raw_line in text.splitlines():
        line = _strip_comments(raw_line).strip()
        if not line:
            continue
        if line.startswith("&"):
            flush()
            gname = line[1:].split()[0].lower()
            groups[gname] = {}
            cur = groups[gname]
            line = line[1 + len(gname):].strip()
            if not line:
                continue
        if cur is None:
            continue  # junk outside groups (e.g. trailing 'NSTX' tag)
        # group terminator: '/' possibly at start of line
        if line == "/" or line.startswith("/"):
            flush()
            cur = None
            continue
        for m in _TOKEN_RE.finditer(line):
            tok = m.group(0)
            if tok.endswith("="):
                flush()
                keypart = tok[:-1].strip()
                idx = None
                if "(" in keypart:
                    base, arg = keypart.split("(", 1)
                    idx = int(arg.rstrip(") ").strip())
                    keypart = base
                pending_key = (keypart.strip().lower(), idx)
            elif tok == "/":
                flush()
                cur = None
                break
            else:
                if tok.endswith("/") and not tok.startswith("'"):
                    # value immediately followed by terminator, e.g. "0.99/"
                    pending_vals.append(tok[:-1])
                    flush()
                    cur = None
                    break
                pending_vals.append(tok)
    flush()
    return groups


def read_namelist_file(path) -> dict:
    with open(path) as f:
        return parse_namelist(f.read())
