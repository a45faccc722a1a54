"""The test suite's own machinery: the per-test time limit of the
repository's root ``conftest.py`` and the registration of every mark the
tests use."""

import ast
import importlib.util
import re
import time
import tomllib
from pathlib import Path

pytest_plugins = ("pytester",)

TESTS = Path(__file__).resolve().parent
ROOT_CONFTEST = TESTS.parent / "conftest.py"

# marks pytest defines itself; every other mark must be in pyproject.toml,
# or a typo (say, "slwo") silently selects or limits nothing
BUILTIN_MARKS = {"filterwarnings", "parametrize", "skip", "skipif",
                 "usefixtures", "xfail"}


def test_time_limit_fails_the_overrunning_test_by_name(pytester):
    pytester.makeconftest(ROOT_CONFTEST.read_text())
    pytester.makeini("""
        [pytest]
        markers =
            timelimit(seconds): per-test time limit
    """)
    pytester.makepyfile(test_sub="""
        import time

        import pytest


        @pytest.mark.timelimit(1)
        def test_sleeps_past_its_limit():
            time.sleep(30)


        def test_passes():
            pass
    """)
    t0 = time.monotonic()
    result = pytester.runpytest_subprocess("-p", "no:cacheprovider")
    elapsed = time.monotonic() - t0
    result.assert_outcomes(passed=1, failed=1)
    result.stdout.fnmatch_lines([
        "*Failed: test_sub.py::test_sleeps_past_its_limit: "
        "time limit 1 s exceeded*",
        "FAILED test_sub.py::test_sleeps_past_its_limit*",
    ])
    assert elapsed < 10, elapsed


def test_every_mark_used_is_registered():
    with open(TESTS.parent / "pyproject.toml", "rb") as f:
        lines = tomllib.load(f)["tool"]["pytest"]["ini_options"]["markers"]
    registered = {re.match(r"\w+", line).group() for line in lines}
    assert {"gpu", "slow", "timelimit"} <= registered
    unregistered = {}
    for path in [*sorted(TESTS.glob("*.py")), ROOT_CONFTEST]:
        for name in re.findall(r"pytest\.mark\.(\w+)", path.read_text()):
            if name not in registered | BUILTIN_MARKS:
                unregistered.setdefault(name, []).append(path.name)
    assert not unregistered, unregistered


def test_every_long_test_in_the_limit_table_exists():
    # a renamed or moved test would otherwise lose its raised limit silently
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT_CONFTEST)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = []
    for nodeid in module.LONG_TESTS:
        path, *names = nodeid.split("::")
        scope = ast.parse((TESTS.parent / path).read_text()).body
        for name in names:
            found = [node for node in scope
                     if isinstance(node, (ast.ClassDef, ast.FunctionDef))
                     and node.name == name]
            if not found:
                missing.append(nodeid)
                break
            scope = found[0].body
    assert not missing, missing
