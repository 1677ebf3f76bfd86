"""SQL table import over Python DB-API drivers (counterpart of
h2o3_tpu/ingest/sql.py).

Reference: h2o-core/src/main/java/water/jdbc/SQLManager.java —
import_sql_table / import_sql_select fan out range-partitioned SELECTs over
JDBC and land chunks in Vecs.

The DB read is host I/O, so the driver is whatever DB-API module matches
the URL scheme: sqlite ships with Python; postgres/mysql resolve to
psycopg2/mysql-connector when installed, with actionable errors
otherwise. Rows fetch column-wise into typed numpy and land on the
device through Column.from_numpy."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from h2o3_tpu_torch.core.frame import T_CAT, Column
from h2o3_tpu_torch.frame_factory import H2OFrame


def _connect(connection_url: str, username: Optional[str],
             password: Optional[str]):
    url = connection_url
    if url.startswith("jdbc:"):        # accept JDBC-style spellings
        url = url[len("jdbc:"):]
    scheme = url.split(":", 1)[0].lower()
    if scheme == "sqlite":
        import sqlite3

        # sqlite:///path/to.db or sqlite:/path
        path = url.split("://", 1)[-1] if "://" in url else url.split(":", 1)[1]
        return sqlite3.connect(path)
    if scheme in ("postgresql", "postgres"):
        try:
            import psycopg2
        except ImportError:
            raise ImportError(
                "postgresql:// URLs need psycopg2, which is not installed "
                "in this environment (SQLManager.java analog is driver-"
                "pluggable; sqlite works out of the box)") from None
        return psycopg2.connect(url, user=username, password=password)
    if scheme == "mysql":
        try:
            import mysql.connector
        except ImportError:
            raise ImportError(
                "mysql:// URLs need mysql-connector-python, which is not "
                "installed; sqlite works out of the box") from None
        from urllib.parse import urlparse

        u = urlparse(url)
        return mysql.connector.connect(
            host=u.hostname, port=u.port or 3306, user=username,
            password=password, database=u.path.lstrip("/"))
    raise ValueError(f"unsupported SQL scheme {scheme!r} "
                     "(sqlite/postgresql/mysql)")


def import_sql_select(connection_url: str, select_query: str,
                      username: Optional[str] = None,
                      password: Optional[str] = None,
                      destination_frame: Optional[str] = None,
                      device=None) -> H2OFrame:
    """h2o.import_sql_select: run the query, type the result columns
    (numeric stays numeric; everything else interns as enum) and build an
    H2OFrame on `device` (default: the runtime's), installed under
    `destination_frame`."""
    conn = _connect(connection_url, username, password)
    try:
        cur = conn.cursor()
        cur.execute(select_query)
        names = [d[0] for d in cur.description]
        rows = cur.fetchall()
    finally:
        conn.close()
    fr = H2OFrame(destination_frame=destination_frame)
    for j, name in enumerate(names):
        vals = [r[j] for r in rows]
        numeric = all(v is None or isinstance(v, (int, float)) for v in vals)
        if numeric:
            arr = np.array([np.nan if v is None else float(v) for v in vals],
                           np.float64)
            fr.add(name, Column.from_numpy(arr, device=device))
        else:
            arr = np.array([None if v is None else str(v) for v in vals],
                           object)
            fr.add(name, Column.from_numpy(arr, ctype=T_CAT, device=device))
    return fr


def import_sql_table(connection_url: str, table: str,
                     columns: Optional[Sequence[str]] = None,
                     username: Optional[str] = None,
                     password: Optional[str] = None,
                     destination_frame: Optional[str] = None,
                     device=None) -> H2OFrame:
    """h2o.import_sql_table (SQLManager.java importSqlTable)."""
    if not table.replace("_", "").replace(".", "").isalnum():
        raise ValueError(f"suspicious table name {table!r}")
    cols = ", ".join(columns) if columns else "*"
    return import_sql_select(connection_url, f"SELECT {cols} FROM {table}",
                             username=username, password=password,
                             destination_frame=destination_frame,
                             device=device)
