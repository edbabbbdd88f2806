"""turbolint configuration for the port: `turbolint_torch.toml` loading
(the JAX package's `repro.analysis.config`, its own copy).

Python 3.11+ ships :mod:`tomllib`; for an older interpreter, with no
package to install, a mini-parser covers the constrained TOML subset the
config actually uses: ``[section]`` headers, ``key = value`` pairs where
the value is a double-quoted string, an integer, ``true``/``false``, or a
(possibly multi-line) array of those.  Full-TOML features the config does
not use (nested tables, dotted keys, literal strings, dates) are rejected
loudly rather than mis-parsed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

try:
    import tomllib as _tomllib            # Python >= 3.11
except ImportError:                       # pragma: no cover - 3.10 path
    _tomllib = None

CONFIG_NAME = "turbolint_torch.toml"


class ConfigError(ValueError):
    """The config could not be parsed or is missing required keys."""


def _parse_value(raw: str, where: str):
    raw = raw.strip()
    if raw.startswith('"'):
        if not raw.endswith('"') or len(raw) < 2:
            raise ConfigError(f"{where}: unterminated string {raw!r}")
        return raw[1:-1]
    if raw in ("true", "false"):
        return raw == "true"
    try:
        return int(raw)
    except ValueError:
        raise ConfigError(f"{where}: unsupported value {raw!r} (the "
                          "mini-parser takes strings, ints, bools and "
                          "arrays of those)") from None


def _split_array(raw: str, where: str) -> List[str]:
    """Split a ``[...]`` body on top-level commas, respecting strings."""
    items: List[str] = []
    buf: List[str] = []
    in_str = False
    for ch in raw:
        if ch == '"':
            in_str = not in_str
            buf.append(ch)
        elif ch == "," and not in_str:
            items.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if in_str:
        raise ConfigError(f"{where}: unterminated string in array")
    items.append("".join(buf))
    return [s for s in (i.strip() for i in items) if s]


def _strip_comment(line: str) -> str:
    out: List[str] = []
    in_str = False
    for ch in line:
        if ch == '"':
            in_str = not in_str
        elif ch == "#" and not in_str:
            break
        out.append(ch)
    return "".join(out).rstrip()


def _parse_mini_toml(text: str, name: str) -> Dict[str, Dict[str, object]]:
    data: Dict[str, Dict[str, object]] = {}
    section: Optional[Dict[str, object]] = None
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        where = f"{name}:{i + 1}"
        line = _strip_comment(lines[i]).strip()
        i += 1
        if not line:
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                raise ConfigError(f"{where}: malformed section header")
            key = line[1:-1].strip()
            if "." in key or not key:
                raise ConfigError(f"{where}: nested/dotted tables are "
                                  "outside the mini-parser's subset")
            section = data.setdefault(key, {})
            continue
        if "=" not in line:
            raise ConfigError(f"{where}: expected `key = value`")
        if section is None:
            raise ConfigError(f"{where}: key outside any [section]")
        key, _, raw = line.partition("=")
        key, raw = key.strip(), raw.strip()
        if raw.startswith("["):
            # accumulate until the closing bracket (multi-line arrays)
            while raw.count("[") > raw.count("]"):
                if i >= len(lines):
                    raise ConfigError(f"{where}: unterminated array")
                raw += " " + _strip_comment(lines[i]).strip()
                i += 1
            body = raw.strip()[1:-1]
            section[key] = [_parse_value(v, where)
                            for v in _split_array(body, where)]
        else:
            section[key] = _parse_value(raw, where)
    return data


def parse_toml(text: str, name: str = CONFIG_NAME
               ) -> Dict[str, Dict[str, object]]:
    if _tomllib is not None:
        return _tomllib.loads(text)
    return _parse_mini_toml(text, name)


@dataclass
class RuleConfig:
    """One rule's section: the file set it runs over plus rule-specific
    keys (kept as a raw dict so rules own their schema)."""
    paths: List[str] = field(default_factory=list)
    options: Dict[str, object] = field(default_factory=dict)

    def strings(self, key: str, default: List[str] = ()) -> List[str]:
        val = self.options.get(key, list(default))
        if not isinstance(val, list) or \
                not all(isinstance(v, str) for v in val):
            raise ConfigError(f"config key {key!r} must be an array of "
                              "strings")
        return list(val)

    def string(self, key: str, default: str = "") -> str:
        val = self.options.get(key, default)
        if not isinstance(val, str):
            raise ConfigError(f"config key {key!r} must be a string")
        return val


@dataclass
class LintConfig:
    root: Path
    rules: Dict[str, RuleConfig]

    def rule(self, name: str) -> RuleConfig:
        return self.rules.get(name, RuleConfig())

    def files_for(self, name: str) -> List[Path]:
        """Resolve a rule's `paths` globs against the repo root, sorted
        and de-duplicated."""
        out: Dict[Path, None] = {}
        for pat in self.rule(name).paths:
            for p in sorted(self.root.glob(pat)):
                if p.is_file():
                    out[p] = None
        return list(out)


def load_config(path: Path) -> LintConfig:
    path = Path(path)
    raw = parse_toml(path.read_text(), path.name)
    rules: Dict[str, RuleConfig] = {}
    for section, body in raw.items():
        paths = body.get("paths", [])
        if not isinstance(paths, list):
            raise ConfigError(f"[{section}] paths must be an array")
        rules[section] = RuleConfig(
            paths=[str(p) for p in paths],
            options={k: v for k, v in body.items() if k != "paths"})
    return LintConfig(root=path.parent.resolve(), rules=rules)


def find_config(start: Path) -> Path:
    """Walk up from ``start`` to the filesystem root looking for
    turbolint_torch.toml (so the linter runs from any repo subdirectory)."""
    cur = Path(start).resolve()
    for cand in [cur] + list(cur.parents):
        p = cand / CONFIG_NAME
        if p.is_file():
            return p
    raise ConfigError(f"no {CONFIG_NAME} found above {start}")
