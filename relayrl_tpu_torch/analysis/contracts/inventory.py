"""The machine-readable contract inventory (``contracts.json``).

Every pass returns its slice; :func:`serialize_inventory` renders the
merged document byte-deterministically (sorted keys, fixed indent,
trailing newline) so two runs over the same tree are byte-identical and
the committed file diffs cleanly. :func:`diff_inventory` is the CON01
regression anchor: the committed inventory vs a fresh extraction —
any drift means a contract changed without the inventory (and therefore
the PR description) saying so.
"""

from __future__ import annotations

import json
import os

INVENTORY_VERSION = 1

# contracts.json ships next to baseline.json as package data.
DEFAULT_INVENTORY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "contracts.json")


def merge_inventory(sections: dict[str, dict]) -> dict:
    doc = {"version": INVENTORY_VERSION}
    for name in sorted(sections):
        if sections[name]:
            doc[name] = sections[name]
    return doc


def serialize_inventory(doc: dict) -> str:
    return json.dumps(doc, indent=2, sort_keys=True,
                      ensure_ascii=True) + "\n"


def load_inventory(path: str) -> dict | None:
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def write_inventory(path: str, doc: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(serialize_inventory(doc))


def diff_inventory(committed: dict, fresh: dict,
                   max_items: int = 8) -> list[str]:
    """Human-readable leaf-level differences, deterministic order."""
    diffs: list[str] = []

    def descend(prefix: str, a: object, b: object) -> None:
        if len(diffs) >= max_items:
            return
        if isinstance(a, dict) and isinstance(b, dict):
            for key in sorted(set(a) | set(b)):
                where = f"{prefix}.{key}" if prefix else str(key)
                if key not in a:
                    diffs.append(f"`{where}` only in fresh extraction")
                elif key not in b:
                    diffs.append(f"`{where}` only in committed inventory")
                else:
                    descend(where, a[key], b[key])
                if len(diffs) >= max_items:
                    return
        elif a != b:
            diffs.append(f"`{prefix}`: committed {a!r} != extracted {b!r}")

    descend("", committed, fresh)
    return diffs
