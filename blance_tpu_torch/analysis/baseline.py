# Copied from blance_tpu/analysis/baseline.py; its format example names
# a path of the port.
"""Accepted-findings allowlist (``analysis/baseline.toml``).

The gate's contract: every finding is either FIXED or explicitly pinned
here with a reason, and any finding not pinned fails the build.  Entries
match on (rule, path[, symbol][, line]) — symbol-based matching survives
unrelated line drift; pin ``line`` only to split two findings of the same
rule inside one function.

The file is TOML.  On Python >= 3.11 (including the 3.12 CI images) it is
parsed with stdlib ``tomllib``; the tiny subset reader below is the
3.10 fallback only (``requires-python = ">=3.10"``, and the analysis
suite must not grow a pip dependency for its own config).  The subset:
``[[finding]]`` array tables, ``key = "string"`` / ``key = integer``
pairs, comments, blank lines.  Either way, validation (required keys,
unknown keys) is shared and strict — a config typo must fail the build,
not silently accept findings.

Format::

    [[finding]]
    rule = "ASY104"
    path = "blance_tpu_torch/orchestrate/orchestrator.py"
    symbol = "Orchestrator._call_assign"
    reason = "legacy no-deadline mode awaits the app callback ..."
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = ["Baseline", "BaselineEntry", "parse_toml_findings"]


@dataclass
class BaselineEntry:
    rule: str
    path: str
    reason: str
    symbol: Optional[str] = None
    line: Optional[int] = None
    used: bool = field(default=False, compare=False)

    def matches(self, finding) -> bool:
        if self.rule != finding.rule or self.path != finding.path:
            return False
        if self.symbol is not None and self.symbol != finding.symbol:
            return False
        if self.line is not None and self.line != finding.line:
            return False
        return True

    def render(self) -> str:
        bits = [self.rule, self.path]
        if self.symbol:
            bits.append(self.symbol)
        if self.line is not None:
            bits.append(f"line {self.line}")
        return " ".join(bits)


def _parse_value(raw: str, path: str, lineno: int):
    raw = raw.strip()
    if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
        body = raw[1:-1]
        # The subset supports the escapes a reason string plausibly needs.
        for esc, ch in (('\\"', '"'), ("\\\\", "\\"), ("\\n", "\n"),
                        ("\\t", "\t")):
            body = body.replace(esc, ch)
        return body
    if raw.lstrip("-").isdigit():
        return int(raw)
    raise ValueError(
        f"{path}:{lineno}: unsupported TOML value {raw!r} (the baseline "
        f"subset accepts double-quoted strings and integers only)")


def parse_toml_findings(text: str,
                        path: str = "<baseline>"
                        ) -> list["BaselineEntry"]:
    """Parse the ``[[finding]]`` array tables out of a TOML document:
    stdlib ``tomllib`` where available, the subset reader on 3.10."""
    try:
        import tomllib
    except ImportError:
        return _parse_subset(text, path)
    try:
        data = tomllib.loads(text)
    except tomllib.TOMLDecodeError as e:
        raise ValueError(f"{path}: invalid TOML: {e}") from e
    unknown_tables = set(data) - {"finding"}
    if unknown_tables:
        raise ValueError(
            f"{path}: unsupported top-level keys {sorted(unknown_tables)} "
            f"(only [[finding]] arrays are recognized)")
    findings = data.get("finding", [])
    if not isinstance(findings, list) or \
            not all(isinstance(e, dict) for e in findings):
        raise ValueError(f"{path}: 'finding' must be an array of tables")
    return _entries_from_dicts(findings, path)


def _parse_subset(text: str, path: str) -> list["BaselineEntry"]:
    """The dependency-free 3.10 fallback parser."""
    entries: list[dict[str, object]] = []
    current: Optional[dict[str, object]] = None
    for lineno, raw_line in enumerate(text.splitlines(), start=1):
        line = raw_line.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[finding]]":
            current = {}
            entries.append(current)
            continue
        if line.startswith("["):
            raise ValueError(
                f"{path}:{lineno}: unsupported table {line!r} (only "
                f"[[finding]] arrays are recognized)")
        if "=" not in line:
            raise ValueError(f"{path}:{lineno}: expected key = value, "
                             f"got {line!r}")
        if current is None:
            raise ValueError(
                f"{path}:{lineno}: key outside a [[finding]] table")
        key, _, value = line.partition("=")
        key = key.strip()
        # Strip a trailing comment from unquoted values; quoted strings
        # may contain '#' so only trim after the closing quote.
        value = value.strip()
        if not value.startswith('"') and "#" in value:
            value = value.split("#", 1)[0].strip()
        elif value.startswith('"'):
            end = value.rfind('"')
            trailer = value[end + 1:].strip()
            if trailer and not trailer.startswith("#"):
                raise ValueError(
                    f"{path}:{lineno}: trailing junk after string value")
            value = value[:end + 1]
        current[key] = _parse_value(value, path, lineno)
    return _entries_from_dicts(entries, path)


def _entries_from_dicts(entries: list[dict[str, object]],
                        path: str) -> list["BaselineEntry"]:
    """Shared strict validation — both parse paths come through here."""
    out = []
    for i, e in enumerate(entries):
        for req in ("rule", "path", "reason"):
            if req not in e:
                raise ValueError(
                    f"{path}: [[finding]] #{i + 1} is missing required "
                    f"key {req!r} (every accepted finding needs a reason)")
        unknown = set(e) - {"rule", "path", "reason", "symbol", "line"}
        if unknown:
            raise ValueError(
                f"{path}: [[finding]] #{i + 1} has unknown keys "
                f"{sorted(unknown)}")
        out.append(BaselineEntry(
            rule=str(e["rule"]), path=str(e["path"]),
            reason=str(e["reason"]),
            symbol=(str(e["symbol"]) if "symbol" in e else None),
            line=(int(e["line"]) if "line" in e else None)))
    return out


class Baseline:
    """The loaded allowlist; splits findings into new vs accepted."""

    def __init__(self, entries: list["BaselineEntry"]) -> None:
        self.entries = entries

    @classmethod
    def load(cls, path: Optional[str]) -> "Baseline":
        if path is None or not os.path.exists(path):
            return cls([])
        with open(path) as f:
            return cls(parse_toml_findings(f.read(), path))

    def split(
        self, findings: list[Any],
    ) -> tuple[list[Any], list[tuple[Any, str]]]:
        """-> (new_findings, [(finding, reason), ...])."""
        new, accepted = [], []
        for f in findings:
            entry = next((e for e in self.entries if e.matches(f)), None)
            if entry is None:
                new.append(f)
            else:
                entry.used = True
                accepted.append((f, entry.reason))
        return new, accepted

    def unused(self) -> list["BaselineEntry"]:
        """Entries that matched nothing — stale pins that must be
        deleted in the same change that fixed their finding.  The CLI
        surfaces them as warnings in the editor loop and as HARD ERRORS
        under ``--ci`` (__main__.py): dead suppressions otherwise
        accumulate and mask the next real finding that happens to match
        them."""
        return [e for e in self.entries if not e.used]
