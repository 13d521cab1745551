"""Circuit layout rendering, as ``zkodst_tpu/utils/layout_viz.py``: one
instance block of the column/row layout of the port's BLAKE2f circuit to
PNG, advice occupancy colored by role, selector rows marked. matplotlib is
imported only when a layout is rendered.
"""

from __future__ import annotations

import numpy as np

# role color indices per advice column
_ROLES = {
    "d0": 1, "s0": 1, "d1": 1, "s1": 1,        # 16-bit lookup pairs
    "d8": 2, "s8": 2,                           # 8-bit lookup pair
    "d15": 3, "s15": 3,                         # 15-bit lookup pair
    "ca": 4, "cb": 4, "cc": 4, "ce": 4, "cf": 4,  # operand copies
    "w": 5,                                     # word cells
}


def render_layout(built, path: str, max_rows: int | None = None) -> str:
    """Render the first instance block of a Blake2fCircuit to `path`."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import ListedColormap

    lay = built._lay
    cols = list(built.circ.advice_names)
    cidx = {c: i for i, c in enumerate(cols)}
    rows = built.rows_per_inst if max_rows is None else min(
        built.rows_per_inst, max_rows)

    grid = np.zeros((rows, len(cols)), np.int8)
    for col, row, _ in lay.place:
        if row < rows:
            grid[row, cidx[col]] = _ROLES.get(col, 6)
    for col, row, _ in lay.consts:
        if row < rows:
            grid[row, cidx[col]] = 6                      # constant copies

    fig, ax = plt.subplots(
        figsize=(8, max(6, min(60, rows / 40))), dpi=110)
    cmap = ListedColormap([
        "#ffffff", "#4c78a8", "#f58518", "#e45756", "#72b7b2", "#54a24b",
        "#b279a2"])
    ax.imshow(grid, aspect="auto", interpolation="nearest", cmap=cmap,
              vmin=0, vmax=6)
    ax.set_xticks(range(len(cols)))
    ax.set_xticklabels(cols, rotation=90, fontsize=7)
    ax.set_ylabel("row (instance block)")
    ax.set_title(
        f"BLAKE2f circuit layout — {built.rows_per_inst} rows/instance, "
        f"{built.ncells} witness cells")
    # selector marks on the left margin
    for q, marks in lay.sel.items():
        for r in marks:
            if r < rows:
                ax.plot([-0.7], [r], marker=".", markersize=1, color="k")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
