"""TwoDimTable: a named table of typed columns for small host results
(gains/lift), the port's copy of h2o3_tpu/utils/twodim.py (the
reference's water/util/TwoDimTable.java): header, column types, rows,
and the {name, columns, data} wire shape."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence


class TwoDimTable:
    def __init__(self, name: str, col_names: Sequence[str],
                 col_types: Optional[Sequence[str]] = None,
                 description: str = ""):
        self.name = name
        self.description = description
        self.col_names = list(col_names)
        self.col_types = list(col_types or ["double"] * len(self.col_names))
        self.rows: List[List[Any]] = []

    def add_row(self, *cells) -> "TwoDimTable":
        if len(cells) == 1 and isinstance(cells[0], (list, tuple)):
            cells = tuple(cells[0])
        if len(cells) != len(self.col_names):
            raise ValueError(f"{len(cells)} cells for "
                             f"{len(self.col_names)} columns")
        self.rows.append(list(cells))
        return self

    def col(self, name: str) -> List[Any]:
        i = self.col_names.index(name)
        return [r[i] for r in self.rows]

    def to_dict(self) -> dict:
        """Columnar: {name, description, columns [{name, type}], data}."""
        return {
            "name": self.name,
            "description": self.description,
            "columns": [{"name": n, "type": t}
                        for n, t in zip(self.col_names, self.col_types)],
            "data": [[r[i] for r in self.rows]
                     for i in range(len(self.col_names))],
        }

    def __repr__(self):
        head = f"{self.name}: " + ", ".join(self.col_names)
        body = "\n".join(
            "  " + " | ".join(f"{c:.5g}" if isinstance(c, float) else str(c)
                              for c in r)
            for r in self.rows[:20])
        more = (f"\n  ... {len(self.rows) - 20} more rows"
                if len(self.rows) > 20 else "")
        return head + "\n" + body + more

    def __len__(self):
        return len(self.rows)
