"""Schema remapping: operator-driven table/column name customization.

Reference: ``crates/data_connector/src/schema.rs`` — deployments pointing
the gateway at an EXISTING database remap logical table/column names to the
physical schema, add extra columns (populated by storage hooks), and skip
logical columns the physical schema lacks.  Loaded from JSON (the reference
uses YAML; JSON needs no extra dependency)::

    {
      "conversations": {"table": "CHAT_SESSIONS",
                        "columns": {"id": "SESSION_ID"},
                        "extra_columns": {"REGION": "TEXT"},
                        "skip_columns": ["metadata"]},
      "conversation_items": {"table": "CHAT_TURNS"}
    }

The port's copy of ``smg_tpu/storage/schema.py``, unchanged but for its
imports.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class TableConfig:
    name: str
    columns: dict = field(default_factory=dict)  # logical -> physical
    extra_columns: dict = field(default_factory=dict)  # physical -> SQL type
    skip_columns: set = field(default_factory=set)  # logical names omitted

    def col(self, logical: str) -> str:
        return self.columns.get(logical, logical)

    def live_columns(self, logical_cols: "list[tuple[str, str]]") -> "list[tuple[str, str]]":
        """(physical_name, sql_type) pairs for DDL/INSERT/SELECT: remapped
        logical columns minus skips, plus the extra columns."""
        out = [
            (self.col(name), sqltype)
            for name, sqltype in logical_cols
            if name not in self.skip_columns
        ]
        out += list(self.extra_columns.items())
        return out


@dataclass
class SchemaConfig:
    tables: dict = field(default_factory=dict)  # logical table -> TableConfig

    def table(self, logical: str) -> TableConfig:
        return self.tables.get(logical) or TableConfig(name=logical)

    @classmethod
    def from_json(cls, text: str) -> "SchemaConfig":
        raw = json.loads(text)
        tables = {}
        for logical, spec in raw.items():
            tables[logical] = TableConfig(
                name=spec.get("table", logical),
                columns=dict(spec.get("columns") or {}),
                extra_columns=dict(spec.get("extra_columns") or {}),
                skip_columns=set(spec.get("skip_columns") or []),
            )
        return cls(tables=tables)

    @classmethod
    def from_file(cls, path: str) -> "SchemaConfig":
        with open(path) as f:
            return cls.from_json(f.read())
