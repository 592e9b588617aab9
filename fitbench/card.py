"""What ``nvidia-smi`` reads of the cards: the name and power limit that
every result prints, and the cards' state (temperature, draw, clocks and
the reasons the clocks are held down) at the ends of the window."""
from __future__ import annotations

import subprocess

STATE = ("index", "temperature.gpu", "power.draw", "clocks.sm",
         "clocks.mem", "clocks_event_reasons.active")


def query(fields) -> list:
    """One list of strings a card, or [] where ``nvidia-smi`` gives none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    return [[v.strip() for v in line.split(",")]
            for line in out.stdout.strip().splitlines()]


def name_and_limit() -> str:
    rows = query(("name", "power.limit"))
    return f"{rows[0][0]}, {rows[0][1]} W" if rows else "unread"


def state() -> list:
    """[index, deg C, W, SM MHz, memory MHz, reasons] a card; without the
    reasons where this ``nvidia-smi`` does not know the field."""
    return query(STATE) or query(STATE[:-1])
