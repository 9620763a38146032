"""Quartz-style cron next-fire computation.

Reference: the engine's cron scheduling is delegated to Quartz
(modules/siddhi-core/pom.xml:68-69; CronWindowProcessor.java:75,
trigger/CronTrigger.java). This is a dependency-free re-implementation of the
subset of the Quartz cron syntax those call sites use:

    sec min hour day-of-month month day-of-week [year]

with `*`, `?`, numbers, names (JAN-DEC, SUN-SAT), lists `a,b`, ranges `a-b`,
and steps `*/n` / `a/n` / `a-b/n`. Day-of-week is Quartz-style 1=SUN..7=SAT.
"""

from __future__ import annotations

import calendar
import datetime as _dt

_MONTHS = {m: i + 1 for i, m in enumerate(
    "JAN FEB MAR APR MAY JUN JUL AUG SEP OCT NOV DEC".split()
)}
_DOWS = {d: i + 1 for i, d in enumerate("SUN MON TUE WED THU FRI SAT".split())}

_FIELD_RANGES = [  # (lo, hi) per field: sec min hour dom mon dow
    (0, 59), (0, 59), (0, 23), (1, 31), (1, 12), (1, 7),
]


def _parse_field(spec: str, lo: int, hi: int, names: dict[str, int]) -> frozenset[int]:
    out: set[int] = set()
    for part in spec.split(","):
        part = part.strip().upper()
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step <= 0:
                raise ValueError(f"bad cron step in {spec!r}")
        if part in ("*", "?", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start = names.get(a, None) if a in names else int(a)
            end = names.get(b, None) if b in names else int(b)
        else:
            v = names[part] if part in names else int(part)
            start = v
            end = hi if "/" in spec and part == spec.split("/", 1)[0] else v
            if step > 1:
                end = hi
        if start is None or end is None or start < lo or end > hi or start > end:
            raise ValueError(f"bad cron field {spec!r} (range {lo}-{hi})")
        out.update(range(start, end + 1, step))
    return frozenset(out)


class CronSchedule:
    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) == 7:
            fields = fields[:6]  # ignore the optional year field
        posix = len(fields) == 5
        if posix:
            fields = ["0"] + fields  # plain 5-field cron: seconds = 0
        if len(fields) != 6:
            raise ValueError(f"cron expression needs 5-7 fields: {expr!r}")
        self.expr = expr
        names = [{}, {}, {}, {}, _MONTHS]
        self.sec, self.min, self.hour, self.dom, self.mon = (
            _parse_field(f, lo, hi, nm)
            for f, (lo, hi), nm in zip(fields[:5], _FIELD_RANGES[:5], names)
        )
        if posix:
            # POSIX day-of-week numbering: 0 (or 7) = SUN, 1 = MON ... 6 = SAT;
            # names map to their POSIX numbers, then everything remaps onto the
            # Quartz 1=SUN..7=SAT encoding used internally
            posix_names = {d: (q - 1) for d, q in _DOWS.items()}
            self.dow = frozenset(
                (v % 7) + 1 for v in _parse_field(fields[5], 0, 7, posix_names)
            )
        else:
            self.dow = _parse_field(fields[5], *_FIELD_RANGES[5], _DOWS)
        self.dom_any = fields[3] in ("*", "?")
        self.dow_any = fields[5] in ("*", "?")

    def _day_matches(self, d: _dt.datetime) -> bool:
        dom_ok = d.day in self.dom
        dow_ok = ((d.weekday() + 1) % 7) + 1 in self.dow  # Mon=0 -> Quartz 2
        if self.dom_any and self.dow_any:
            return True
        if self.dom_any:
            return dow_ok
        if self.dow_any:
            return dom_ok
        return dom_ok or dow_ok  # Quartz: specified dom OR dow

    def next_fire_ms(self, after_ms: int) -> int:
        """Earliest fire time strictly after `after_ms` (epoch millis, local)."""
        d = _dt.datetime.fromtimestamp(after_ms / 1000.0).replace(microsecond=0)
        d += _dt.timedelta(seconds=1)
        for _ in range(4 * 366 * 24 * 60):  # bound the scan (~4 years of minutes)
            if d.month not in self.mon:
                d = _dt.datetime(d.year + (d.month == 12), d.month % 12 + 1, 1)
                continue
            if not self._day_matches(d):
                d = (d + _dt.timedelta(days=1)).replace(hour=0, minute=0, second=0)
                continue
            if d.hour not in self.hour:
                d = (d + _dt.timedelta(hours=1)).replace(minute=0, second=0)
                continue
            if d.minute not in self.min:
                d = (d + _dt.timedelta(minutes=1)).replace(second=0)
                continue
            if d.second not in self.sec:
                nxt = min((s for s in self.sec if s > d.second), default=None)
                if nxt is None:
                    d = (d + _dt.timedelta(minutes=1)).replace(second=0)
                else:
                    d = d.replace(second=nxt)
                continue
            return int(d.timestamp() * 1000)
        raise ValueError(f"cron {self.expr!r}: no fire time within 4 years")
