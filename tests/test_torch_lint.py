"""turbolint for the port (`repro_torch.analysis`) against the JAX
package's (`repro.analysis`).

- The counterparts of tests/test_analysis.py's fixture tests, on the
  port's linter.
- The JAX package's fixtures under its own configs (its roots: ``jnp`` /
  ``jax`` / ``lax``): the port's linter gives the JAX package's findings,
  finding for finding.
- The port's own idioms on small fixtures: PyTorch's sinks and washes,
  CUDA-graph cells and captures, the wrapper form of the parity rule.
- The mini-TOML parsers give the same dicts on both repo configs.
- The port lints clean under `turbolint_torch.toml`; the CLI's exit
  codes.
"""
import textwrap
from pathlib import Path

import pytest

from repro.analysis import config as ref_config
from repro.analysis import lint as ref_lint
from repro_torch.analysis.config import (CONFIG_NAME, ConfigError,
                                         _parse_mini_toml, find_config,
                                         load_config, parse_toml)
from repro_torch.analysis.lint import main, run

REPO_ROOT = Path(__file__).resolve().parent.parent


def make_repo(tmp_path: Path, config: str, files: dict,
              name: str = CONFIG_NAME) -> Path:
    tmp_path.mkdir(parents=True, exist_ok=True)
    cfg = tmp_path / name
    cfg.write_text(textwrap.dedent(config))
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
    return cfg


def lint(tmp_path: Path, config: str, files: dict):
    return run(load_config(make_repo(tmp_path, config, files)))


def rules_of(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# The JAX package's fixtures (tests/test_analysis.py), verbatim
# ---------------------------------------------------------------------------

HOST_SYNC_CFG = '''
    [host_sync]
    paths = ["hot.py"]
    device_attrs = ["state", "emitted"]
    device_roots = ["jnp", "jax", "lax"]
    numpy_roots = ["np"]
'''

RECOMPILE_CFG = '''
    [recompile]
    paths = ["eng.py"]
    bucketed = ["seq_b", "interpret"]
'''

LOCK_CFG = '''
    [locks]
    paths = ["cli.py"]
    lock_attr = "_cv"
    guarded_attrs = ["pipeline", "_closed"]
    mutating_methods = ["tick", "submit"]
    exempt_methods = ["__init__"]
'''

LOCK_SRC = '''
    class Client:
        def __init__(self):
            self.pipeline = object()     # exempt: pre-thread
            self._closed = False

        def good(self):
            with self._cv:
                self.pipeline.tick()
                self._closed = True

        def good_nested(self):
            while True:
                with self._cv:
                    if True:
                        self.pipeline.tick()

        def bad_call(self):
            self.pipeline.tick()         # TL003

        def bad_write(self):
            if True:
                self._closed = True      # TL003

        def read_only(self):
            return self.pipeline.idle()  # reads are fine
'''

PARITY_CFG = '''
    [kernel_parity]
    paths = ["kernels/*.py", "tests/test_k.py"]
    ref_module = "kernels/ref.py"
    exclude = ["ref.py", "__init__.py"]
    parity = ["foo_pallas:foo_ref:fused_foo"]
'''

PARITY_FILES = {
    "kernels/foo.py": '''
        def foo_pallas(x):
            return x
    ''',
    "kernels/ref.py": '''
        def foo_ref(x):
            return x
    ''',
    "tests/test_k.py": '''
        def test_parity():
            assert fused_foo(1, impl="interpret") == foo_ref(1)
    ''',
}

REFERENCE_CASES = {
    "host_sync_sinks": (HOST_SYNC_CFG, {"hot.py": '''
        import jax, jax.numpy as jnp, numpy as np

        def f(state):
            x = jnp.zeros(3)
            a = x.item()                 # TL001 .item on device value
            b = np.asarray(state.emitted)    # TL001 asarray of device
            c = float(jnp.sum(x))        # TL001 float() of device
            jax.block_until_ready(x)     # TL001 barrier
            return a, b, c
    '''}),
    "host_sync_flow": (HOST_SYNC_CFG, {"hot.py": '''
        import jax.numpy as jnp, numpy as np

        def f():
            dev = jnp.arange(4)
            alias = dev + 1
            return np.asarray(alias)     # TL001 via propagation
    '''}),
    "host_sync_washed": (HOST_SYNC_CFG, {"hot.py": '''
        import numpy as np

        def f(rows):
            host = np.array([r.weight for r in rows], np.float32)
            n = len(host)
            return int(n), host.item()   # host data: no findings
    '''}),
    "host_sync_suppressed": (HOST_SYNC_CFG, {"hot.py": '''
        import jax.numpy as jnp, numpy as np

        def f():
            x = jnp.zeros(3)
            a = np.asarray(x)  # turbolint: allow-sync(final flush)
            # turbolint: allow-sync(deliberate readback)
            b = float(jnp.sum(x))
            return a, b
    '''}),
    "suppression_grammar": (HOST_SYNC_CFG, {"hot.py": '''
        import jax.numpy as jnp, numpy as np

        def f():
            x = jnp.zeros(3)
            a = np.asarray(x)  # turbolint: allow-sync()
            b = 1  # turbolint: allow-sync(nothing to silence here)
            c = 2  # turbolint: allow-bogus(key)
            return a, b, c
    '''}),
    "recompile_closure": (RECOMPILE_CFG, {"eng.py": '''
        import jax

        def make(seq_len, seq_b):
            @jax.jit
            def f(x):
                return x[:seq_len] + seq_b   # seq_len not bucketed
            return f
    '''}),
    "recompile_partial_jit": (RECOMPILE_CFG, {"eng.py": '''
        import jax
        from functools import partial

        def make(seq_b):
            @partial(jax.jit, donate_argnums=(1,))
            def f(p, x):
                return x[:seq_b]
            return f
    '''}),
    "recompile_pallas": (RECOMPILE_CFG, {"eng.py": '''
        import jax
        from jax.experimental import pallas as pl

        def kern(x, rows, interpret=False):
            return pl.pallas_call(
                _body,
                grid=(rows,),               # rows not bucketed
                interpret=interpret,
            )(x)
    '''}),
    "recompile_operands": (RECOMPILE_CFG, {"eng.py": '''
        import jax
        from jax.experimental import pallas as pl

        def kern(x, interpret=False):
            return pl.pallas_call(
                _body,
                out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                interpret=interpret,
            )(x)                            # x is a runtime operand
    '''}),
    "locks": (LOCK_CFG, {"cli.py": LOCK_SRC}),
    "locks_suppressed": (LOCK_CFG, {"cli.py": LOCK_SRC.replace(
        "self.pipeline.tick()         # TL003",
        "self.pipeline.tick()  # turbolint: allow-lock(single-thread)")}),
    "parity_clean": (PARITY_CFG, PARITY_FILES),
    "parity_missing_ref": (PARITY_CFG, {
        **PARITY_FILES,
        "kernels/ref.py": "def other_ref(x):\n    return x\n"}),
    "parity_missing_interpret": (PARITY_CFG, {
        **PARITY_FILES, "tests/test_k.py": '''
def test_parity():
    assert fused_foo(1) == foo_ref(1)    # no interpret mode
'''}),
    "parity_undeclared": (PARITY_CFG, {
        **PARITY_FILES,
        "kernels/bar.py": "def bar_pallas(x):\n    return x\n"}),
    "parity_sweep": (PARITY_CFG, {
        **PARITY_FILES, "tests/test_k.py": '''
def test_parity():
    for impl in ("xla", "interpret"):
        assert fused_foo(1, impl=impl) == foo_ref(1)
'''}),
}

#: the rules each fixture gives (tests/test_analysis.py's expectations)
REFERENCE_RULES = {
    "host_sync_sinks": ["TL001"] * 4,
    "host_sync_flow": ["TL001"],
    "host_sync_washed": [],
    "host_sync_suppressed": [],
    "recompile_closure": ["TL002"],
    "recompile_partial_jit": [],
    "recompile_pallas": ["TL002"],
    "recompile_operands": [],
    "locks": ["TL003", "TL003"],
    "locks_suppressed": ["TL003"],
    "parity_clean": [],
    "parity_missing_ref": ["TL004"],
    "parity_missing_interpret": ["TL004"],
    "parity_undeclared": ["TL004"],
    "parity_sweep": [],
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_port_linter_gives_the_reference_findings_on_its_fixtures(
        tmp_path, case):
    config, files = REFERENCE_CASES[case]
    ref_cfg = make_repo(tmp_path / "ref", config, files,
                        name=ref_config.CONFIG_NAME)
    port_cfg = make_repo(tmp_path / "port", config, files)
    want = [f.render() for f in ref_lint.run(ref_config.load_config(
        ref_cfg))]
    got = [f.render() for f in run(load_config(port_cfg))]
    assert got == want


# ---------------------------------------------------------------------------
# Counterparts of tests/test_analysis.py's fixture tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(REFERENCE_RULES))
def test_fixture_rules(tmp_path, case):
    config, files = REFERENCE_CASES[case]
    assert rules_of(lint(tmp_path, config, files)) == REFERENCE_RULES[case]


def test_fixture_messages_name_the_culprit(tmp_path):
    cfg, files = REFERENCE_CASES["recompile_closure"]
    assert "seq_len" in lint(tmp_path / "a", cfg, files)[0].message
    cfg, files = REFERENCE_CASES["recompile_pallas"]
    assert "rows" in lint(tmp_path / "b", cfg, files)[0].message
    cfg, files = REFERENCE_CASES["locks"]
    found = lint(tmp_path / "c", cfg, files)
    assert "tick" in found[0].message and "_closed" in found[1].message
    cfg, files = REFERENCE_CASES["parity_missing_ref"]
    assert "foo_ref" in lint(tmp_path / "d", cfg, files)[0].message
    cfg, files = REFERENCE_CASES["parity_missing_interpret"]
    assert "interpret" in lint(tmp_path / "e", cfg, files)[0].message
    cfg, files = REFERENCE_CASES["parity_undeclared"]
    assert "bar_pallas" in lint(tmp_path / "f", cfg, files)[0].message


def test_suppression_requires_reason_and_use(tmp_path):
    findings = lint(tmp_path, *REFERENCE_CASES["suppression_grammar"])
    # empty reason -> TL000 AND the sync still reported; unused ->
    # TL000; unknown key -> TL000
    assert rules_of(findings).count("TL000") == 3
    assert rules_of(findings).count("TL001") == 1


def test_mini_toml_parser_subset():
    data = _parse_mini_toml(textwrap.dedent('''
        # comment
        [alpha]
        s = "text # not a comment"
        n = 7
        flag = true
        items = [
            "a",   # trailing comment
            "b",
        ]
        [beta]
        empty = []
    '''), "t.toml")
    assert data["alpha"] == {"s": "text # not a comment", "n": 7,
                             "flag": True, "items": ["a", "b"]}
    assert data["beta"] == {"empty": []}


def test_mini_toml_rejects_unsupported():
    with pytest.raises(ConfigError, match="dotted"):
        _parse_mini_toml("[a.b]\n", "t.toml")
    with pytest.raises(ConfigError, match="unsupported value"):
        _parse_mini_toml("[a]\nx = 1.5\n", "t.toml")
    with pytest.raises(ConfigError, match="outside any"):
        _parse_mini_toml("x = 1\n", "t.toml")


@pytest.mark.parametrize("name", ["turbolint.toml", "turbolint_torch.toml"])
def test_parsers_agree_with_the_reference_on_both_configs(name):
    text = (REPO_ROOT / name).read_text()
    want = ref_config._parse_mini_toml(text, name)
    assert _parse_mini_toml(text, name) == want
    assert parse_toml(text, name) == ref_config.parse_toml(text, name) \
        == want


def test_find_config_walks_up(tmp_path):
    (tmp_path / CONFIG_NAME).write_text("[host_sync]\npaths = []\n")
    sub = tmp_path / "a" / "b"
    sub.mkdir(parents=True)
    assert find_config(sub) == tmp_path / CONFIG_NAME
    with pytest.raises(ConfigError):
        find_config(Path("/nonexistent-root-dir"))


# ---------------------------------------------------------------------------
# The port's idioms
# ---------------------------------------------------------------------------

TORCH_SYNC_CFG = '''
    [host_sync]
    paths = ["hot.py"]
    device_attrs = ["state", "emitted"]
    device_roots = ["torch", "F"]
    numpy_roots = ["np"]
    sync_functions = ["_host"]
    host_calls = ["is_available", "current_stream"]
'''


def test_torch_sinks_are_flagged(tmp_path):
    findings = lint(tmp_path, TORCH_SYNC_CFG, {"hot.py": '''
        import numpy as np
        import torch

        def _host(t):
            return t.cpu().numpy()

        def f(state, lengths):
            x = torch.zeros(3)
            a = x.tolist()                  # TL001
            b = state.emitted.cpu()         # TL001
            c = torch.argmax(x).numpy()     # TL001
            d = int(x.max())                # TL001: a method of a device value
            e = _host(state.emitted)        # TL001: a sync helper
            torch.cuda.synchronize()        # TL001
            return a, b, c, d, e
    '''})
    assert [(f.rule, f.line) for f in findings] == \
        [("TL001", n) for n in (10, 11, 12, 13, 14, 15)]


def test_torch_host_data_is_clean(tmp_path):
    findings = lint(tmp_path, TORCH_SYNC_CFG, {"hot.py": '''
        import numpy as np
        import torch

        def _host(t):
            return t.cpu().numpy()

        def f(state, rows):
            x = torch.zeros(3)
            n = int(x.size(0)) + int(x.numel()) + x.dim()
            ok = bool(torch.cuda.is_available())
            host = _host(state.emitted)  # turbolint: allow-sync(flush)
            k = int(host[0])             # washed by the helper
            lens = [int(r) for r in rows]
            return n, ok, k, lens, x.shape[0], str(x.device)
    '''})
    assert findings == []


CELL_CFG = '''
    [recompile]
    paths = ["eng.py"]
    bucketed = ["seq_b", "batch_b", "prefix_len"]
    cell_calls = ["_run_cell:1:2"]
    operands = ["state", "cell", "body"]
'''


def test_cuda_graph_cells_and_captures(tmp_path):
    findings = lint(tmp_path, CELL_CFG, {"eng.py": '''
        import functools
        import torch

        class Engine:
            def good(self, table, seq_b, batch_b, prefix_len):
                return self._run_cell(
                    table, ("sfx", prefix_len, seq_b, batch_b),
                    functools.partial(self._body, prefix_len), {}, {})

            def bad_key(self, table, seq_len, batch_b):
                return self._run_cell(table, (seq_len, batch_b),
                                      self._body, {}, {})

            def bad_body(self, table, seq_b, width):
                return self._run_cell(table, (seq_b,),
                                      functools.partial(self._body, width),
                                      {}, {})

            def capture(self, state, graph, scale_of_row):
                with torch.cuda.graph(graph):
                    self._tick(state)
                    self._mul(scale_of_row)    # a static of the call
    '''})
    assert [(f.rule, f.line) for f in findings] == [
        ("TL002", 12), ("TL002", 16), ("TL002", 21)]
    assert "seq_len" in findings[0].message
    assert "width" in findings[1].message
    assert "scale_of_row" in findings[2].message


WRAPPER_CFG = '''
    [kernel_parity]
    paths = ["kernels/*.py", "tests/test_*.py"]
    entry_module = "kernels/ops.py"
    ref_module = "kernels/ref.py"
    card_tests = "tests/test_cuda.py"
    exclude_entries = ["on_cpu"]
    parity = ["fused_foo:foo_ref:fused_foo"]
'''

WRAPPER_FILES = {
    "kernels/ops.py": '''
        def on_cpu(x):
            return True

        def fused_foo(x):
            return x
    ''',
    "kernels/ref.py": "def foo_ref(x):\n    return x\n",
    "tests/test_cpu.py": '''
        def test_foo():
            assert ops.fused_foo(1) == foo_ref(1)
    ''',
    "tests/test_cuda.py": '''
        def test_cuda_foo():
            assert ops.fused_foo(1) == foo_ref(1)
    ''',
}


@pytest.mark.parametrize("case, change, culprit", [
    ("clean", {}, None),
    ("no oracle", {"kernels/ref.py": "def bar_ref(x):\n    return x\n"},
     "foo_ref"),
    ("no CPU test", {"tests/test_cpu.py": "def test_x():\n    pass\n"},
     "CPU test"),
    ("no card test", {"tests/test_cuda.py": "def test_x():\n    pass\n"},
     "card test"),
    ("undeclared", {"kernels/ops.py": textwrap.dedent(
        WRAPPER_FILES["kernels/ops.py"]) +
        "\ndef fused_bar(x):\n    return x\n"}, "fused_bar"),
])
def test_wrapper_parity(tmp_path, case, change, culprit):
    findings = lint(tmp_path, WRAPPER_CFG, {**WRAPPER_FILES, **change})
    if culprit is None:
        assert findings == []
    else:
        assert rules_of(findings) == ["TL004"]
        assert culprit in findings[0].message


# ---------------------------------------------------------------------------
# The real tree and the CLI
# ---------------------------------------------------------------------------

def test_port_lints_clean():
    cfg = load_config(REPO_ROOT / CONFIG_NAME)
    findings = run(cfg)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_config_covers_the_hot_paths():
    cfg = load_config(REPO_ROOT / CONFIG_NAME)
    rel = {p.relative_to(REPO_ROOT).as_posix()
           for section in ("host_sync", "recompile", "locks")
           for p in cfg.files_for(section)}
    assert {"src/repro_torch/core/pipeline.py",
            "src/repro_torch/runtime/engine.py",
            "src/repro_torch/runtime/graphs.py",
            "src/repro_torch/runtime/sampling.py",
            "src/repro_torch/kernels/ops.py",
            "src/repro_torch/obs/metrics.py",
            "src/repro_torch/api/client.py",
            "src/repro_torch/cluster/pool.py"} <= rel
    assert all(p.startswith("src/repro_torch/") for p in rel)


def test_cli_exit_codes(tmp_path, capsys):
    cfg = make_repo(tmp_path, TORCH_SYNC_CFG, {"hot.py": '''
        import torch

        def f():
            return torch.zeros(3).tolist()
    '''})
    assert main(["--config", str(cfg)]) == 1
    out = capsys.readouterr().out
    assert "hot.py" in out and "TL001" in out
    clean = make_repo(tmp_path / "c2", TORCH_SYNC_CFG,
                      {"hot.py": "x = 1\n"})
    assert main(["--config", str(clean)]) == 0
    broken = make_repo(tmp_path / "c3", "[host_sync]\npaths = \"hot.py\"\n", {})
    assert main(["--config", str(broken)]) == 2
