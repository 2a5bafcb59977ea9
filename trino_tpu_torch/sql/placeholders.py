"""`?` placeholders of a prepared statement (reference role: the protocol's
prepared-statement parameters).

A copy of `_split_placeholders`, `_substitute` and `_literal` from
trino_tpu/dbapi.py, shared by the runner's EXECUTE and the port's DB-API
driver (trino_tpu_torch/dbapi.py, which re-exports the two error classes).
A placeholder/parameter mismatch or an unsupported parameter type raises
InterfaceError, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence


class Error(Exception):
    """The DB-API's base error (PEP 249)."""


class InterfaceError(Error):
    pass


def _split_placeholders(operation: str) -> list:
    """Split on '?' placeholders, ignoring ones inside '...' string literals
    (with '' escapes), "..." quoted identifiers, and -- or /* */ comments."""
    parts, buf, quote = [], [], None
    i, n = 0, len(operation)
    while i < n:
        ch = operation[i]
        if quote is not None:
            buf.append(ch)
            if ch == quote:
                if i + 1 < n and operation[i + 1] == quote:  # '' escape
                    buf.append(operation[i + 1])
                    i += 1
                else:
                    quote = None
        elif ch == "-" and operation.startswith("--", i):
            j = operation.find("\n", i)
            j = n if j < 0 else j
            buf.append(operation[i:j])
            i = j - 1
        elif ch == "/" and operation.startswith("/*", i):
            j = operation.find("*/", i)
            j = n if j < 0 else j + 2
            buf.append(operation[i:j])
            i = j - 1
        elif ch in ("'", '"'):
            quote = ch
            buf.append(ch)
        elif ch == "?":
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
        i += 1
    parts.append("".join(buf))
    return parts


def substitute(operation: str, parameters: Sequence) -> str:
    """qmark substitution with SQL literal quoting."""
    if not parameters:
        return operation
    parts = _split_placeholders(operation)
    if len(parts) - 1 != len(parameters):
        raise InterfaceError(
            f"statement has {len(parts) - 1} placeholders, "
            f"{len(parameters)} parameters given"
        )
    out = [parts[0]]
    for p, rest in zip(parameters, parts[1:]):
        out.append(_literal(p))
        out.append(rest)
    return "".join(out)


def _literal(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    import datetime
    import decimal

    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, datetime.date):
        return f"date '{v.isoformat()}'"
    raise InterfaceError(f"unsupported parameter type {type(v).__name__}")
