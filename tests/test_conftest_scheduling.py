"""The xdist scheduler of the repository's root conftest.py: loadfile, with
the JAX package's faked-mesh files cut into their cost groups, and a test
that ended its worker reported once and not run again."""

import ast

import pytest


@pytest.fixture
def root(pytestconfig):
    """The root conftest.py as pytest loaded it (tests/conftest.py, too,
    is a module named ``conftest``)."""
    path = pytestconfig.rootpath / "conftest.py"
    return pytestconfig.pluginmanager.get_plugin(str(path))


@pytest.fixture
def scheduler(root, pytestconfig, monkeypatch):
    # one worker, as under -n 1 --dist loadfile
    for name, value in (
        ("dist", "loadfile"), ("tx", ["popen"]), ("loadscopereorder", True)
    ):
        monkeypatch.setattr(pytestconfig.option, name, value, raising=False)
    return root.pytest_xdist_make_scheduler(pytestconfig, None)


class _Node:
    """What a scheduler uses of xdist's WorkerController."""

    shutting_down = False

    def __init__(self):
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.extend(indices)

    def shutdown(self):
        self.shutting_down = True


def test_cost_groups_name_test_functions_of_their_files(root, pytestconfig):
    for path, groups in root.COST_GROUPS.items():
        tree = ast.parse((pytestconfig.rootpath / path).read_text())
        defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        assert set(groups) <= defined, path


def test_scopes_cut_only_the_grouped_functions(
    root, scheduler, pytestconfig, monkeypatch
):
    scope = scheduler._split_scope
    mg = "tests/test_mg_dist.py"
    assert scope(f"{mg}::test_sharded_checkpoint_roundtrip[dense]") == (
        f"{mg}::checkpoint"
    )
    assert scope(f"{mg}::test_sharded_setup_rejects_straddling_blocks") == (
        f"{mg}::checkpoint"
    )
    par = "tests/test_parallel.py"
    assert scope(f"{par}::test_distributed_fused_gcr_matches_single_device"
                 "[True]") == f"{par}::solvers"
    assert scope(f"{par}::test_balanced_factors") == par
    assert scope("tests/test_torch_cli.py::test_checkpoint[a]") == (
        "tests/test_torch_cli.py"
    )
    monkeypatch.setattr(pytestconfig.option, "dist", "load")
    assert root.pytest_xdist_make_scheduler(pytestconfig, None) is None


def test_crashed_test_is_reported_once_and_not_run_again(scheduler):
    ids = [f"tests/test_a.py::test_{i}" for i in range(4)]
    ids.append("tests/test_b.py::test_0")
    first = _Node()
    scheduler.add_node(first)
    scheduler.add_node_collection(first, ids)
    scheduler.schedule()
    assert first.sent == [0, 1, 2, 3]
    scheduler.mark_test_complete(first, 0)

    # the worker dies while test_1 runs
    assert scheduler.remove_node(first) == ids[1]
    second = _Node()
    scheduler.add_node(second)
    scheduler.add_node_collection(second, ids)
    scheduler.schedule()
    scheduler.mark_test_complete(second, 4)
    assert second.sent == [4, 2, 3]
