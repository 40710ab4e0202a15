"""Time quantums and time-based view naming (reference: time.go).

A time field materializes extra views per time unit: ``standard_2017``,
``standard_201701``, ``standard_20170102``, ``standard_2017010203``
(reference time.go:75-101). A range query decomposes [start, end) into a
minimal cover of pre-materialized views by walking up from small units to
large and back down (reference time.go:104-176 viewsByTimeRange).
"""

from __future__ import annotations

from datetime import datetime, timedelta

TIME_FORMAT = "%Y-%m-%dT%H:%M"

VALID_QUANTUMS = {"Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H", ""}


def valid_quantum(q: str) -> bool:
    """reference time.go:44-55."""
    return q in VALID_QUANTUMS


def parse_time(t) -> datetime:
    """Parse a PQL timestamp string or unix seconds (reference
    time.go:220-234)."""
    if isinstance(t, str):
        try:
            return datetime.strptime(t, TIME_FORMAT)
        except ValueError as e:
            raise ValueError("cannot parse string time") from e
    if isinstance(t, int) and not isinstance(t, bool):
        return datetime.utcfromtimestamp(t)
    raise ValueError("arg must be a timestamp")


def view_by_time_unit(name: str, t: datetime, unit: str) -> str:
    """reference time.go:75-88."""
    fmt = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}.get(unit)
    if fmt is None:
        return ""
    return f"{name}_{t.strftime(fmt)}"


def views_by_time(name: str, t: datetime, quantum: str) -> list[str]:
    """All unit views a timestamped bit lands in (reference time.go:91-101)."""
    return [
        v for u in quantum if (v := view_by_time_unit(name, t, u))
    ]


def _add_year(t: datetime) -> datetime:
    return t.replace(year=t.year + 1)


def _add_month(t: datetime) -> datetime:
    """reference time.go:183-189 addMonth: clamp to day 1 for days >28 to
    avoid double-month hops (Jan 31 + 1mo = Mar 2)."""
    if t.day > 28:
        t = t.replace(day=1)
    if t.month == 12:
        return t.replace(year=t.year + 1, month=1)
    return t.replace(month=t.month + 1)


def _next_year_gte(t: datetime, end: datetime) -> bool:
    nxt = _add_year(t)
    return nxt.year == end.year or end > nxt


def _next_month_gte(t: datetime, end: datetime) -> bool:
    nxt = _add_month_exact(t)
    return (nxt.year, nxt.month) == (end.year, end.month) or end > nxt


def _add_month_exact(t: datetime) -> datetime:
    """time.AddDate(0,1,0) equivalent with Go's normalization (Jan 31 ->
    Mar 2/3)."""
    month = t.month + 1
    year = t.year
    if month > 12:
        month = 1
        year += 1
    day = t.day
    # Go normalizes out-of-range days by rolling into the next month.
    while True:
        try:
            return t.replace(year=year, month=month, day=day)
        except ValueError:
            # emulate normalization: day 31 in a 30-day month -> day 1 + 1mo
            days_in = (_first_of_next(year, month) - timedelta(days=1)).day
            overflow = day - days_in
            t2 = t.replace(year=year, month=month, day=days_in) + timedelta(
                days=overflow
            )
            return t2


def _first_of_next(year: int, month: int) -> datetime:
    if month == 12:
        return datetime(year + 1, 1, 1)
    return datetime(year, month + 1, 1)


def _next_day_gte(t: datetime, end: datetime) -> bool:
    nxt = t + timedelta(days=1)
    return (nxt.year, nxt.month, nxt.day) == (end.year, end.month, end.day) or end > nxt


def views_by_time_range(name: str, start: datetime, end: datetime, quantum: str) -> list[str]:
    """Minimal view cover of [start, end) (reference time.go:104-176)."""
    has_year = "Y" in quantum
    has_month = "M" in quantum
    has_day = "D" in quantum
    has_hour = "H" in quantum

    t = start
    results: list[str] = []

    # Walk up from smallest units to largest.
    if has_hour or has_day or has_month:
        while t < end:
            if has_hour:
                if not _next_day_gte(t, end):
                    break
                elif t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t = t + timedelta(hours=1)
                    continue
            if has_day:
                if not _next_month_gte(t, end):
                    break
                elif t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t = t + timedelta(days=1)
                    continue
            if has_month:
                if not _next_year_gte(t, end):
                    break
                elif t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_month(t)
                    continue
            break

    # Walk back down from largest units to smallest.
    while t < end:
        if has_year and _next_year_gte(t, end):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _add_year(t)
        elif has_month and _next_month_gte(t, end):
            results.append(view_by_time_unit(name, t, "M"))
            # clamped advance (reference time.go:144,162 use addMonth, not
            # AddDate) so Jan 31 + 1mo lands in February, not March
            t = _add_month(t)
        elif has_day and _next_day_gte(t, end):
            results.append(view_by_time_unit(name, t, "D"))
            t = t + timedelta(days=1)
        elif has_hour:
            results.append(view_by_time_unit(name, t, "H"))
            t = t + timedelta(hours=1)
        else:
            break

    return results


def view_time_part(view: str) -> str:
    """reference time.go:331-334."""
    return view.rsplit("_", 1)[-1]


def min_max_views(views: list[str], quantum: str) -> tuple[str, str]:
    """Min/max same-granularity views (reference time.go:240-274)."""
    views = sorted(views)
    if "Y" in quantum:
        chars = 4
    elif "M" in quantum:
        chars = 6
    elif "D" in quantum:
        chars = 8
    elif "H" in quantum:
        chars = 10
    else:
        chars = 0
    lo = next((v for v in views if len(view_time_part(v)) == chars), "")
    hi = next((v for v in reversed(views) if len(view_time_part(v)) == chars), "")
    return lo, hi


def time_of_view(view: str, adj: bool) -> datetime | None:
    """Start time of a view's period; end when ``adj`` (reference
    time.go:279-327)."""
    if not view:
        return None
    part = view_time_part(view)
    n = len(part)
    if n == 4:
        t = datetime.strptime(part, "%Y")
        return _add_year(t) if adj else t
    if n == 6:
        t = datetime.strptime(part, "%Y%m")
        return _add_month(t) if adj else t
    if n == 8:
        t = datetime.strptime(part, "%Y%m%d")
        return t + timedelta(days=1) if adj else t
    if n == 10:
        t = datetime.strptime(part, "%Y%m%d%H")
        return t + timedelta(hours=1) if adj else t
    raise ValueError(f"invalid time format on view: {view}")


def view_cover(field, from_arg, to_arg, standard_name: str) -> list[str] | None:
    """The minimal time-view cover of [from, to] for a field, clamping a
    missing bound to the field's existing time views (reference
    executor.go:1376-1397 + time.go viewsByTimeRange).  None when a bound
    is missing and no time views exist (the range is provably empty).
    Raises ValueError when the field has no time quantum."""
    q = field.options.time_quantum
    if not q:
        raise ValueError(
            f"field {field.name!r} has no time quantum for time range"
        )
    start = parse_time(from_arg) if from_arg is not None else None
    end = parse_time(to_arg) if to_arg is not None else None
    if start is None or end is None:
        time_views = [
            v for v in field.views if v.startswith(standard_name + "_")
        ]
        lo_v, hi_v = min_max_views(time_views, q)
        if start is None:
            if not lo_v:
                return None
            start = time_of_view(lo_v, False)
        if end is None:
            if not hi_v:
                return None
            end = time_of_view(hi_v, True)
    return views_by_time_range(standard_name, start, end, q)
