"""Minimal stdlib .xlsx reader (zipfile + XML; a copy of `mammodissect/utils/xlsx.py`):
enough to read the vendored category workbook `Concepts/Extended_Breast_text_categories.xlsx`
that the reference's `Plots/process_result_csvs.ipynb` cell 16 parses with
pandas/openpyxl (openpyxl is not a dependency, and the workbook is simple: shared
strings, no formulas that matter for the concept -> category mapping).

Supported cell types: shared string (t="s"), inline string (t="inlineStr"),
formula/string (t="str"), boolean (t="b"), and numeric (default)."""
from __future__ import annotations

import re
import zipfile
from typing import Dict, List
from xml.etree import ElementTree as ET

_NS = {
    "m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
    "r": "http://schemas.openxmlformats.org/officeDocument/2006/relationships",
    "pr": "http://schemas.openxmlformats.org/package/2006/relationships",
}

_CELL_REF = re.compile(r"([A-Z]+)([0-9]+)")


def _col_index(ref: str) -> int:
    """'A'->0, 'Z'->25, 'AA'->26 …"""
    n = 0
    for ch in ref:
        n = n * 26 + (ord(ch) - ord("A") + 1)
    return n - 1


def _cell_text(c: ET.Element, shared: List[str]):
    t = c.get("t", "n")
    if t == "inlineStr":
        parts = [el.text or "" for el in c.findall(".//m:t", _NS)]
        return "".join(parts)
    v = c.find("m:v", _NS)
    if v is None or v.text is None:
        return None
    if t == "s":
        return shared[int(v.text)]
    if t == "str":
        return v.text
    if t == "b":
        return bool(int(v.text))
    # numeric: keep ints as ints where exact
    try:
        f = float(v.text)
        return int(f) if f.is_integer() else f
    except ValueError:
        return v.text


def read_xlsx(path: str) -> Dict[str, List[List]]:
    """{sheet_name: rows} in workbook sheet order; each row is a list of cell values
    (None for blanks), padded to the row's max referenced column."""
    with zipfile.ZipFile(path) as z:
        # shared strings (concatenate rich-text runs)
        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", _NS):
                shared.append("".join(t.text or "" for t in si.findall(".//m:t", _NS)))

        # sheet name -> target file via workbook rels
        rels_root = ET.fromstring(z.read("xl/_rels/workbook.xml.rels"))
        rel_target = {
            rel.get("Id"): rel.get("Target").lstrip("/")
            for rel in rels_root.findall("pr:Relationship", _NS)
        }
        wb = ET.fromstring(z.read("xl/workbook.xml"))
        sheets: Dict[str, List[List]] = {}
        for sh in wb.findall("m:sheets/m:sheet", _NS):
            name = sh.get("name")
            target = rel_target[sh.get(f"{{{_NS['r']}}}id")]
            if not target.startswith("xl/"):
                target = "xl/" + target
            sheets[name] = _read_sheet(ET.fromstring(z.read(target)), shared)
        return sheets


def _read_sheet(root: ET.Element, shared: List[str]) -> List[List]:
    rows: List[List] = []
    for row in root.findall("m:sheetData/m:row", _NS):
        cells: List = []
        for c in row.findall("m:c", _NS):
            ref = c.get("r")
            if ref:
                m = _CELL_REF.match(ref)
                idx = _col_index(m.group(1)) if m else len(cells)
            else:
                idx = len(cells)
            while len(cells) <= idx:
                cells.append(None)
            cells[idx] = _cell_text(c, shared)
        rows.append(cells)
    width = max((len(r) for r in rows), default=0)
    return [r + [None] * (width - len(r)) for r in rows]


def sheet_columns(rows: List[List]) -> Dict[str, List]:
    """First row = headers (pandas `ExcelFile.parse` default); returns
    {header: non-empty values below it} preserving column order."""
    if not rows:
        return {}
    header, body = rows[0], rows[1:]
    out: Dict[str, List] = {}
    for j, name in enumerate(header):
        if name is None or (isinstance(name, str) and not name.strip()):
            continue
        out[str(name)] = [r[j] for r in body if j < len(r) and r[j] is not None
                          and not (isinstance(r[j], str) and not r[j].strip())]
    return out


def load_workbook_columns(path: str) -> Dict[str, Dict[str, List]]:
    """{sheet_name: {column_header: values}} — the shape cell 16's double loop walks."""
    return {name: sheet_columns(rows) for name, rows in read_xlsx(path).items()}
