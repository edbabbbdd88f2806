"""turbolint for the port: `python -m repro_torch.analysis.lint [--config PATH]`.

Loads `turbolint_torch.toml` (found by walking up from the cwd), runs the
four rules over their configured file sets, applies suppression
comments, and prints `path:line:col: RULE message` lines sorted by
location.  Exit status 0 when clean, 1 when any finding survives, 2
on a config error.
"""
from __future__ import annotations

import argparse
import ast
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.analysis import rules
from repro_torch.analysis.config import (ConfigError, LintConfig, find_config,
                                   load_config)


def _parse(path: Path) -> Tuple[ast.Module, str]:
    source = path.read_text()
    return ast.parse(source, filename=str(path)), source


def run(cfg: LintConfig) -> List[rules.Finding]:
    findings: List[rules.Finding] = []
    # parse each file once, shared across rules
    cache: Dict[Path, Tuple[ast.Module, str]] = {}

    def parsed(path: Path) -> Tuple[ast.Module, str]:
        if path not in cache:
            cache[path] = _parse(path)
        return cache[path]

    def rel(path: Path) -> str:
        try:
            return path.resolve().relative_to(cfg.root).as_posix()
        except ValueError:
            return path.as_posix()

    per_file = {
        "host_sync": rules.check_host_sync,
        "recompile": rules.check_recompile,
        "locks": rules.check_locks,
    }
    raw: List[rules.Finding] = []
    scanned: Dict[Path, None] = {}
    for section, check in per_file.items():
        for path in cfg.files_for(section):
            tree, _ = parsed(path)
            raw.extend(check(cfg, path, tree, rel(path)))
            scanned[path] = None

    parity_sources: Dict[Path, Tuple[ast.Module, str]] = {}
    for path in cfg.files_for("kernel_parity"):
        parity_sources[Path(rel(path))] = parsed(path)
        scanned[path] = None
    if parity_sources:
        raw.extend(rules.check_kernel_parity(cfg, parity_sources))

    # de-dup (the taint walk passes loop bodies twice), then the
    # suppression pass: per-file tables, applied to raw findings
    raw = list(dict.fromkeys(raw))
    tables: Dict[str, rules.Suppressions] = {}
    for path in scanned:
        r = rel(path)
        tables[r] = rules.Suppressions(parsed(path)[1], r)
    for f in raw:
        table = tables.get(f.path)
        if table is not None and table.allows(f.line, f.rule):
            continue
        findings.append(f)
    for table in tables.values():
        findings.extend(table.malformed)
        findings.extend(table.unused())
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="turbolint: repo-specific static checks")
    ap.add_argument("--config", type=Path, default=None,
                    help="explicit turbolint_torch.toml (default: walk up "
                    "from the cwd)")
    args = ap.parse_args(argv)
    try:
        cfg_path = args.config if args.config is not None \
            else find_config(Path.cwd())
        cfg = load_config(cfg_path)
    except ConfigError as e:
        print(f"turbolint: {e}", file=sys.stderr)
        return 2
    findings = run(cfg)
    for f in findings:
        print(f.render())
    if findings:
        print(f"turbolint: {len(findings)} finding(s)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
