"""Dependency-free .xlsx export of the erosion-study workbook.

Counterpart of ``lidar_object_detection_tpu/eval/xlsx.py``, kept as its
own copy.  The reference's headline artifact is
``master_car_statistics.csv.xlsx``: three sheets
(``master_car_statistics``, ``Ero_vs_NoERo``, ``Ero_stats``) whose cached
formula values carry the published numbers (74.48 % mean inside-%,
+7.67 % mean improvement, 5.87 std -- BASELINE.md).  This module writes an
OOXML workbook with the same sheet names, column layout and formulas, with
cached values computed by :mod:`.erosion_study`, using only ``zipfile``:
an .xlsx is a zip of small XML parts.

Layout (pinned against the reference workbook by the JAX package):

- ``master_car_statistics``: row 1 section titles (``Without Erosion`` /
  ``Erosion``), row 2 column headers, data rows 3+: no-erosion run in
  columns A-H, erosion run in columns J-Q (same (frame, car) row pairing).
- ``Ero_vs_NoERo``: A/B = per-car inside-%% with/without erosion,
  C = difference, E2 = ``STDEV.S(C2:C<n>)``, F = per-car %% improvement,
  G2 = ``AVERAGE(F2:F<n>)``.
- ``Ero_stats``: A/B = eroded inside/outside point counts, D/E = eroded
  inside/outside %%, G2 = ``AVERAGE(D2:D<n>)`` (the 74.48 headline cell).
"""

from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import Iterable, List, Sequence, Tuple, Union
from xml.sax.saxutils import escape

from lidar_object_detection_tpu_torch.eval.erosion_study import (
    ErosionStudyResult, ErosionStudyRow)
from lidar_object_detection_tpu_torch.eval.statistics import CarStatistics


@dataclasses.dataclass(frozen=True)
class Formula:
    """A formula cell with its cached (pre-computed) value."""

    expr: str          # without the leading '='
    cached: float


Cell = Union[None, str, int, float, Formula]


def _col_name(i: int) -> str:
    name = ""
    i += 1
    while i:
        i, rem = divmod(i - 1, 26)
        name = chr(ord("A") + rem) + name
    return name


def _cell_xml(ref: str, value: Cell) -> str:
    if value is None:
        return ""
    if isinstance(value, Formula):
        return (f'<c r="{ref}"><f>{escape(value.expr)}</f>'
                f"<v>{value.cached!r}</v></c>")
    if isinstance(value, str):
        return (f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">'
                f"{escape(value)}</t></is></c>")
    if isinstance(value, bool):
        value = int(value)
    return f'<c r="{ref}"><v>{value!r}</v></c>'


def _sheet_xml(rows: Sequence[Sequence[Cell]]) -> str:
    body = []
    for r, row in enumerate(rows, start=1):
        cells = "".join(
            _cell_xml(f"{_col_name(c)}{r}", v) for c, v in enumerate(row))
        if cells:
            body.append(f'<row r="{r}">{cells}</row>')
    return (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main"><sheetData>'
        + "".join(body) + "</sheetData></worksheet>")


def write_xlsx(path: str,
               sheets: Iterable[Tuple[str, Sequence[Sequence[Cell]]]]) -> None:
    """Write ``[(sheet_name, rows), ...]`` as a minimal valid .xlsx."""
    sheets = list(sheets)
    if not sheets:
        raise ValueError("xlsx needs at least one sheet")
    n = len(sheets)
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
        'content-types">'
        '<Default Extension="rels" ContentType="application/vnd.'
        'openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/'
        'vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        + "".join(
            f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
            'ContentType="application/vnd.openxmlformats-officedocument.'
            'spreadsheetml.worksheet+xml"/>' for i in range(n))
        + "</Types>")
    root_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
        '2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships/officeDocument" '
        'Target="xl/workbook.xml"/></Relationships>')
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.'
        'org/officeDocument/2006/relationships"><sheets>'
        + "".join(
            f'<sheet name="{escape(name)}" sheetId="{i + 1}" '
            f'r:id="rId{i + 1}"/>' for i, (name, _) in enumerate(sheets))
        + "</sheets></workbook>")
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
        '2006/relationships">'
        + "".join(
            f'<Relationship Id="rId{i + 1}" Type="http://schemas.'
            'openxmlformats.org/officeDocument/2006/relationships/'
            f'worksheet" Target="worksheets/sheet{i + 1}.xml"/>'
            for i in range(n))
        + "</Relationships>")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", root_rels)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        for i, (_, rows) in enumerate(sheets):
            z.writestr(f"xl/worksheets/sheet{i + 1}.xml", _sheet_xml(rows))


def read_xlsx(path: str):
    """Minimal reader (inline strings + numbers + cached formula values),
    for round-trip tests: returns ``{sheet_name: {cell_ref: value}}``."""
    import re

    with zipfile.ZipFile(path) as z:
        wb = z.read("xl/workbook.xml").decode()
        names = re.findall(r'<sheet name="([^"]+)"[^>]*r:id="rId(\d+)"', wb)
        rels = z.read("xl/_rels/workbook.xml.rels").decode()
        targets = dict(re.findall(
            r'Id="rId(\d+)"[^>]*Target="([^"]+)"', rels))
        out = {}
        for name, rid in names:
            xml = z.read("xl/" + targets[rid]).decode()
            cells = {}
            for ref, body in re.findall(r'<c r="([A-Z]+\d+)"[^>]*>(.*?)</c>',
                                        xml, re.S):
                m = re.search(r"<t[^>]*>([^<]*)</t>", body)
                if m:
                    from xml.sax.saxutils import unescape
                    cells[ref] = unescape(m.group(1))
                    continue
                m = re.search(r"<v>([^<]*)</v>", body)
                if m:
                    v = m.group(1)
                    cells[ref] = float(v) if "." in v or "e" in v.lower() \
                        else int(v)
            out[name] = cells
    return out


def _master_rows(raw_rows: Sequence[CarStatistics],
                 eroded_rows: Sequence[CarStatistics]) -> List[List[Cell]]:
    header = ["frame", "car_id", "total_points", "points_inside_bbox",
              "points_outside_bbox", "inside_percentage_withoutErosion",
              "outside_percentage", "is_matched"]
    header_e = ["frame", "car_id", "total_points", "points_inside_bbox",
                "points_outside_bbox", "Inside Points using Erosion",
                "outside_percentage", "is_matched"]
    rows: List[List[Cell]] = [
        ["Without Erosion", None, None, None, None, None, None, None,
         None, "Erosion"],
        header + [None] + header_e,
    ]
    by_key = {(r.frame, r.car_id): r for r in eroded_rows}
    for r in raw_rows:
        e = by_key.get((r.frame, r.car_id))
        left: List[Cell] = [r.frame, r.car_id, r.total_points,
                            r.points_inside_bbox, r.points_outside_bbox,
                            round(r.inside_percentage, 2),
                            round(r.outside_percentage, 2),
                            int(r.is_matched)]
        if e is None:
            rows.append(left)
            continue
        rows.append(left + [None] + [
            e.frame, e.car_id, e.total_points, e.points_inside_bbox,
            e.points_outside_bbox, round(e.inside_percentage, 2),
            round(e.outside_percentage, 2), int(e.is_matched)])
    return rows


def export_erosion_workbook(path: str,
                            raw_rows: Sequence[CarStatistics],
                            eroded_rows: Sequence[CarStatistics],
                            study: ErosionStudyResult) -> None:
    """Write the 3-sheet workbook mirroring the reference artifact.

    ``raw_rows`` / ``eroded_rows`` are the two runs' full master-CSV rows;
    ``study`` is :func:`..erosion_study.analyze` over their matched join.
    """
    joined: Sequence[ErosionStudyRow] = study.rows
    n = len(joined) + 1  # data ends at row n (headers in row 1)

    vs_rows: List[List[Cell]] = [[
        "Points inside using Erosion", "Points inside without using Erosion",
        "Differences", "Average_Difference", "Standard deviation",
        "Percentage Improvement on Average"]]
    for i, r in enumerate(joined):
        row: List[Cell] = [round(r.inside_pct_eroded, 2),
                           round(r.inside_pct_raw, 2),
                           Formula(f"A{i + 2}-B{i + 2}",
                                   round(r.inside_pct_eroded
                                         - r.inside_pct_raw, 10)),
                           None, None,
                           r.pct_improvement]
        if i == 0:
            row[4] = Formula(f"_xlfn.STDEV.S(C2:C{n})",
                             study.std_inside_pct_diff)
            row.append(Formula(f"AVERAGE(F2:F{n})",
                               study.mean_pct_improvement))
        vs_rows.append(row)

    stats_rows: List[List[Cell]] = [[
        "points_inside_bbox", "points_outside_bbox", None,
        "Inside Points", "Outside Points", None, "Average points inside"]]
    for i, r in enumerate(joined):
        row = [r.inside_eroded, r.total_points_eroded - r.inside_eroded,
               None, round(r.inside_pct_eroded, 2),
               round(100.0 - r.inside_pct_eroded, 2)]
        if i == 0:
            row += [None, Formula(f"AVERAGE(D2:D{n})",
                                  study.mean_inside_pct_eroded)]
        stats_rows.append(row)

    write_xlsx(path, [
        ("master_car_statistics", _master_rows(raw_rows, eroded_rows)),
        ("Ero_vs_NoERo", vs_rows),
        ("Ero_stats", stats_rows),
    ])
