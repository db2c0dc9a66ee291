"""Run a notebook of this directory in plain Python, without Jupyter.

The card's machine has no Jupyter and no matplotlib; this runner needs
neither. It reads the notebook's JSON and executes its code cells in order
in one namespace, from the notebook's directory (as Jupyter runs it):

- ``DEVICE`` is the runner's ``device`` argument (default ``"cuda"``): the
  set-up cell's own ``DEVICE = ...`` line is skipped, so
  ``run_notebook(path, device="cpu")`` runs every entry point on the CPU;
- each cell's last expression is evaluated and kept, as Jupyter displays
  it;
- a cell tagged ``"figure"`` in its metadata draws, and imports
  ``matplotlib.pyplot`` itself. Without matplotlib such a cell must raise
  ``ImportError`` (the runner fails if it does not); with matplotlib the
  runner selects the Agg backend and closes the figures after the cell.
  No other cell draws, so every number a notebook prints or asserts is
  computed without matplotlib.

Any other exception propagates: the run fails.

    python examples_torch/notebooks/_runner.py quantum_volume --device cpu
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import json
import pathlib
import sys
import time
from typing import Any, Callable, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
FIGURE_TAG = "figure"


@dataclasses.dataclass
class Cell:
    """A code cell of a notebook: its position among the notebook's cells,
    its source and whether it is a figure cell."""
    index: int
    source: str
    figure: bool


@dataclasses.dataclass
class CellRun:
    """What running a cell gave: its last expression's value (None for a
    figure cell without matplotlib), whether it drew, and its seconds."""
    cell: Cell
    value: Any
    drew: bool
    seconds: float


def notebook_path(name_or_path) -> pathlib.Path:
    """The path of a notebook given by path or by name in this directory."""
    path = pathlib.Path(name_or_path)
    if path.suffix != ".ipynb":
        path = HERE / f"{path.name}.ipynb"
    return path.resolve()


def code_cells(path) -> List[Cell]:
    """The notebook's code cells, in order."""
    nb = json.loads(notebook_path(path).read_text())
    cells = []
    for index, cell in enumerate(nb["cells"]):
        if cell["cell_type"] != "code":
            continue
        source = cell["source"]
        source = "".join(source) if isinstance(source, list) else source
        tags = cell.get("metadata", {}).get("tags", [])
        cells.append(Cell(index, source, FIGURE_TAG in tags))
    return cells


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _sets_device(stmt: ast.stmt) -> bool:
    return (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and stmt.targets[0].id == "DEVICE")


def _run_source(source: str, namespace: dict, filename: str) -> Any:
    """Execute a cell; return the value of its last statement where that
    is an expression, as Jupyter displays it."""
    tree = ast.parse(source, filename=filename)
    tree.body = [stmt for stmt in tree.body if not _sets_device(stmt)]
    last = None
    if tree.body and isinstance(tree.body[-1], ast.Expr):
        last = ast.Expression(tree.body.pop().value)
    exec(compile(tree, filename, "exec"), namespace)
    if last is None:
        return None
    return eval(compile(last, filename, "eval"), namespace)


def run_notebook(path, device: str = "cuda",
                 on_cell: Optional[Callable[[CellRun], None]] = None):
    """Run a notebook's code cells in order in one namespace.

    :param path: a notebook path, or a notebook name in this directory.
    :param device: the ``DEVICE`` every entry point of the notebook takes.
    :param on_cell: called with each cell's :class:`CellRun` once it ran.
    :return: ``(namespace, runs)``: the namespace after the last cell and
        a :class:`CellRun` for each code cell.
    """
    path = notebook_path(path)
    drawing = have_matplotlib()
    if drawing:
        import matplotlib
        matplotlib.use("Agg")
    namespace = {"__name__": "__main__", "DEVICE": device}
    runs = []
    with contextlib.chdir(path.parent):
        for cell in code_cells(path):
            filename = f"{path.name}:cell{cell.index}"
            t0 = time.perf_counter()
            value, drew = None, False
            if cell.figure and not drawing:
                try:
                    _run_source(cell.source, namespace, filename)
                except ImportError as err:
                    if "matplotlib" not in str(err):
                        raise
                else:
                    raise RuntimeError(f"{filename} is a figure cell but "
                                       "ran without matplotlib")
            else:
                value = _run_source(cell.source, namespace, filename)
                if cell.figure:
                    import matplotlib.pyplot as plt
                    drew = bool(plt.get_fignums())
                    plt.close("all")
            run = CellRun(cell, value, drew, time.perf_counter() - t0)
            runs.append(run)
            if on_cell is not None:
                on_cell(run)
    return namespace, runs


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("notebooks", nargs="+")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for name in args.notebooks:
        _, runs = run_notebook(name, device=args.device)
        print(f"{notebook_path(name).name}: {len(runs)} code cells, "
              f"{sum(r.seconds for r in runs):.2f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
