"""Reference-format input-deck parser.

Semantics match the reference param_reader (ref:include/param_reader.h:91-160):
the file is scanned line by line; the first whitespace-separated token of a
line is the key; the following token(s) are the value(s); the first matching
line wins; everything else on the line (e.g. ``// comments``) is ignored;
lines whose first token matches no requested key are skipped, so decorative
section banners parse transparently.

Vector values are stored as ``key N v1 v2 ... vN``
(ref:src/input.cpp:113-118, e.g. ``diagnostic_fields 4 vorticity ...``).

Copied from hifiles_tpu/config/deck.py (lines 1-75) unchanged but for this
paragraph: the port imports nothing of hifiles_tpu, and the
relative imports now resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

from typing import TypeVar

T = TypeVar("T")

_MISSING = object()


class Deck:
    """Parsed key-value view of a HiFiLES-format input file."""

    def __init__(self, text: str, name: str = "<deck>"):
        self.name = name
        self._lines: list[list[str]] = []
        for raw in text.splitlines():
            toks = raw.split()
            if toks:
                self._lines.append(toks)

    @classmethod
    def from_file(cls, path: str) -> "Deck":
        with open(path) as f:
            return cls(f.read(), name=path)

    def _find(self, key: str) -> list[str] | None:
        for toks in self._lines:
            if toks[0] == key:
                return toks[1:]
        return None

    def get_scalar(self, key: str, typ: type = str, default=_MISSING):
        toks = self._find(key)
        if toks is None or not toks:
            if default is _MISSING:
                raise KeyError(f"required parameter '{key}' missing from {self.name}")
            return default
        try:
            if typ is bool:
                return bool(int(toks[0]))
            return typ(toks[0])
        except ValueError:
            if default is _MISSING:
                raise
            return default

    def get_vector(self, key: str, typ: type = str, optional: bool = True):
        """``key N v1 .. vN`` form (ref:src/input.cpp:316 note)."""
        toks = self._find(key)
        if toks is None:
            if optional:
                return []
            raise KeyError(f"required vector parameter '{key}' missing")
        n = int(toks[0])
        vals = toks[1:1 + n]
        if len(vals) != n:
            raise ValueError(f"vector parameter '{key}' declares {n} values, "
                             f"found {len(vals)}")
        return [typ(v) for v in vals]

    def has(self, key: str) -> bool:
        return self._find(key) is not None
