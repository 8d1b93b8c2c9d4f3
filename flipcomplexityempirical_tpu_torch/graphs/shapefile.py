"""Native ESRI shapefile I/O: no geopandas/fiona/shapely dependency.

The port's copy of ``flipcomplexityempirical_tpu/graphs/shapefile.py``.

BASELINE config 5 names "real precinct dual graph (small-state
shapefile)" as a capability; the reference's geopandas import is a dead
breadcrumb (grid_chain_sec11.py:4). This environment has no geo stack
and no network, so the capability is supplied natively: a pure
numpy/struct reader for the two files a precinct map needs — the ``.shp``
geometry file (Polygon/PolygonZ/PolygonM records) and its ``.dbf``
dBase-III attribute table — returning a GeoJSON-shaped FeatureCollection
dict that ``dualgraph.from_geojson`` ingests unchanged. A matching
writer exists so the round trip (write -> read -> dual graph) is testable
hermetically, and so synthetic states can be exported for external GIS
tools.

Format notes (ESRI Shapefile Technical Description, July 1998):
- .shp = 100-byte header (big-endian file code 9994 + length, little-
  endian version 1000 + shape type + 8-double bbox), then records of
  [BE record number, BE content length (16-bit words)] + [LE shape type,
  bbox, numParts, numPoints, part offsets, xy doubles].
- .dbf = dBase III: 32-byte header (0x03, date, LE record count, header
  size, record size), 32-byte field descriptors (11-byte name, type C/N/F,
  length, decimal count), 0x0D terminator; records are fixed-width ASCII
  prefixed by a deletion flag; 0x1A terminates the file.
- Ring orientation: .shp outer rings are clockwise, holes counter-
  clockwise — the signed-shoelace convention ``from_geojson`` already
  uses to subtract hole areas, so rings pass through untouched.
"""

from __future__ import annotations

import os
import struct

import numpy as np

SHAPE_NULL = 0
SHAPE_POLYGON = 5
SHAPE_POLYGONZ = 15
SHAPE_POLYGONM = 25
_POLYGON_TYPES = (SHAPE_POLYGON, SHAPE_POLYGONZ, SHAPE_POLYGONM)


def _read_dbf(path: str) -> list:
    """Parse a dBase III table into a list of property dicts. Character
    fields come back str, numeric fields int/float, blanks None."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 33:
        raise ValueError(f"{path}: truncated dBase file ({len(buf)} bytes)")
    n_rec = struct.unpack_from("<I", buf, 4)[0]
    hdr_size, rec_size = struct.unpack_from("<HH", buf, 8)
    if hdr_size > len(buf) or hdr_size < 33:
        raise ValueError(f"{path}: dBase header size {hdr_size} "
                         f"inconsistent with file length {len(buf)}")
    if rec_size < 1:  # spec minimum: the deletion flag byte
        raise ValueError(f"{path}: dBase record size {rec_size} corrupt")
    if hdr_size + n_rec * rec_size > len(buf) + 1:  # +1: some writers
        raise ValueError(                           # omit the 0x1A EOF
            f"{path}: dBase table truncated ({n_rec} records of "
            f"{rec_size} bytes declared, {len(buf) - hdr_size} present)")
    fields = []
    off = 32
    while off < hdr_size - 1 and buf[off] != 0x0D:
        raw_name = buf[off:off + 11].split(b"\x00", 1)[0]
        ftype = chr(buf[off + 11])
        flen = buf[off + 16]
        fdec = buf[off + 17]
        fields.append((raw_name.decode("ascii", "replace"), ftype,
                       flen, fdec))
        off += 32
    recs = []
    pos = hdr_size
    for _ in range(n_rec):
        if pos + rec_size > len(buf):
            break
        rec = buf[pos:pos + rec_size]
        pos += rec_size
        # NOTE: rows soft-deleted by dBase tools (flag '*') are parsed
        # like live rows — .shp geometry has no deletion concept, so
        # dropping them here would break the mandatory 1:1 shp/dbf row
        # alignment (the convention shapefile readers follow)
        props = {}
        p = 1
        for fname, ftype, flen, fdec in fields:
            cell = rec[p:p + flen]
            p += flen
            text = cell.decode("ascii", "replace").strip()
            if ftype in ("N", "F"):
                if not text:
                    props[fname] = None
                elif ftype == "N" and fdec == 0 and "." not in text:
                    props[fname] = int(text)
                else:
                    props[fname] = float(text)
            elif ftype == "L":
                props[fname] = (True if text in ("T", "t", "Y", "y")
                                else False if text in ("F", "f", "N", "n")
                                else None)
            else:                   # C, D, ... -> raw text
                props[fname] = text
        recs.append(props)
    return recs


def _read_shp(path: str) -> list:
    """Parse polygon records of a .shp into GeoJSON-style geometry dicts
    (one "Polygon" whose coordinate list holds ALL parts/rings — exactly
    what from_geojson._rings iterates). Null shapes come back None."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 100:
        raise ValueError(f"{path}: truncated shapefile "
                         f"({len(buf)} bytes < 100-byte header)")
    file_code, = struct.unpack_from(">i", buf, 0)
    if file_code != 9994:
        raise ValueError(f"{path}: not a shapefile (file code {file_code})")
    file_len_words, = struct.unpack_from(">i", buf, 24)
    if 2 * file_len_words > len(buf):
        raise ValueError(
            f"{path}: truncated shapefile (header declares "
            f"{2 * file_len_words} bytes, {len(buf)} present)")
    version, global_type = struct.unpack_from("<ii", buf, 28)
    if version != 1000:
        raise ValueError(f"{path}: unsupported shapefile version {version}")
    if global_type not in _POLYGON_TYPES and global_type != SHAPE_NULL:
        raise ValueError(
            f"{path}: shape type {global_type} is not a polygon type; "
            "precinct dual graphs need Polygon (5/15/25) shapefiles")
    end = min(len(buf), 2 * file_len_words)
    geoms = []
    pos = 100
    while pos + 8 <= end:
        _rec_no, content_words = struct.unpack_from(">ii", buf, pos)
        pos += 8
        rec_end = pos + 2 * content_words
        if rec_end > len(buf) or content_words < 2:
            raise ValueError(
                f"{path}: truncated or corrupt record at byte {pos - 8} "
                f"(content length {content_words} words, file "
                f"{len(buf)} bytes)")
        stype, = struct.unpack_from("<i", buf, pos)
        if stype == SHAPE_NULL:
            geoms.append(None)
        elif stype in _POLYGON_TYPES:
            n_parts, n_points = struct.unpack_from("<ii", buf, pos + 36)
            parts = np.frombuffer(buf, "<i4", n_parts, pos + 44)
            pts = np.frombuffer(buf, "<f8", 2 * n_points,
                                pos + 44 + 4 * n_parts)
            pts = pts.reshape(n_points, 2)
            bounds = np.append(parts, n_points)
            rings = [pts[bounds[i]:bounds[i + 1]].tolist()
                     for i in range(n_parts)]
            geoms.append({"type": "Polygon", "coordinates": rings})
        else:
            raise ValueError(f"{path}: record shape type {stype} "
                             "unsupported (polygon types only)")
        pos = rec_end
    return geoms


def read_shapefile(path: str) -> dict:
    """Read ``<path>.shp`` (+ sibling ``.dbf`` when present) into a
    GeoJSON FeatureCollection dict. ``path`` may include or omit the
    .shp suffix. Null-shape records are dropped (with their attribute
    rows kept aligned)."""
    base, ext = os.path.splitext(path)
    shp = path if ext.lower() == ".shp" else path + ".shp"
    base = base if ext.lower() == ".shp" else path
    geoms = _read_shp(shp)
    dbf = base + ".dbf"
    props = _read_dbf(dbf) if os.path.exists(dbf) else [{} for _ in geoms]
    if len(props) != len(geoms):
        raise ValueError(
            f"{shp}: {len(geoms)} shapes but {len(props)} attribute rows "
            f"in {dbf} — the sidecar does not belong to this .shp")
    feats = [{"type": "Feature", "properties": p, "geometry": g}
             for g, p in zip(geoms, props) if g is not None]
    return {"type": "FeatureCollection", "features": feats}


def _ring_signed_area(ring: np.ndarray) -> float:
    x, y = ring[:, 0], ring[:, 1]
    return float((x * np.roll(y, -1) - np.roll(x, -1) * y).sum() / 2.0)


def write_shapefile(path: str, feature_collection: dict) -> None:
    """Write a GeoJSON FeatureCollection of Polygon/MultiPolygon features
    as ``<path>.shp`` + ``.shx`` + ``.dbf``. First rings are emitted
    clockwise and subsequent (hole) rings counter-clockwise per the spec.
    Attribute columns are the union of feature property keys: bool -> L
    (logical), int -> N, float -> N with 6 decimals, everything else
    -> C."""
    base = os.path.splitext(path)[0]
    feats = feature_collection["features"]

    shp_records = []
    for feat in feats:
        geom = feat["geometry"]
        if geom["type"] == "Polygon":
            parts_nested = [geom["coordinates"]]
        elif geom["type"] == "MultiPolygon":
            parts_nested = geom["coordinates"]
        else:
            raise ValueError(f"unsupported geometry {geom['type']!r}")
        rings = []
        for poly in parts_nested:
            for k, ring in enumerate(poly):
                r = np.asarray(ring, np.float64)
                if not np.allclose(r[0], r[-1]):
                    r = np.vstack([r, r[:1]])
                want_cw = (k == 0)
                if (_ring_signed_area(r) > 0) == want_cw:
                    r = r[::-1]   # shoelace>0 is CCW; outer must be CW
                rings.append(r)
        shp_records.append(rings)

    # --- .shp + .shx ---
    rec_payloads = []
    for rings in shp_records:
        n_points = sum(len(r) for r in rings)
        all_pts = np.vstack(rings)
        bbox = (all_pts[:, 0].min(), all_pts[:, 1].min(),
                all_pts[:, 0].max(), all_pts[:, 1].max())
        parts = np.cumsum([0] + [len(r) for r in rings[:-1]]).astype("<i4")
        payload = struct.pack("<i4d2i", SHAPE_POLYGON, *bbox,
                              len(rings), n_points)
        payload += parts.tobytes() + all_pts.astype("<f8").tobytes()
        rec_payloads.append(payload)

    gx = np.vstack([np.vstack(r) for r in shp_records])
    gbox = (gx[:, 0].min(), gx[:, 1].min(), gx[:, 0].max(), gx[:, 1].max())
    shp_len = 100 + sum(8 + len(p) for p in rec_payloads)
    header = struct.pack(">i5ii", 9994, 0, 0, 0, 0, 0, shp_len // 2)
    header += struct.pack("<ii", 1000, SHAPE_POLYGON)
    header += struct.pack("<8d", *gbox, 0, 0, 0, 0)
    with open(base + ".shp", "wb") as f:
        f.write(header)
        for i, payload in enumerate(rec_payloads):
            f.write(struct.pack(">ii", i + 1, len(payload) // 2))
            f.write(payload)
    shx_len = 100 + 8 * len(rec_payloads)
    with open(base + ".shx", "wb") as f:
        f.write(header[:24] + struct.pack(">i", shx_len // 2) + header[28:])
        off = 100
        for payload in rec_payloads:
            f.write(struct.pack(">ii", off // 2, len(payload) // 2))
            off += 8 + len(payload)

    # --- .dbf ---
    keys = []
    for feat in feats:
        for k in (feat.get("properties") or {}):
            if k not in keys:
                keys.append(k)
    cols = []
    for k in keys:
        vals = [(feat.get("properties") or {}).get(k) for feat in feats]
        # bool is an int subclass: test it FIRST or True lands in an
        # N column as the unparseable text 'True'
        if all(isinstance(v, (bool, np.bool_)) or v is None for v in vals):
            cols.append((k, "L", 1, 0))
        elif all(not isinstance(v, (bool, np.bool_))
                 and (isinstance(v, (int, np.integer)) or v is None)
                 for v in vals):
            width = max([len(str(v)) for v in vals if v is not None] + [1])
            cols.append((k, "N", min(max(width, 4), 18), 0))
        elif all(not isinstance(v, (bool, np.bool_))
                 and (isinstance(v, (int, float, np.number)) or v is None)
                 for v in vals):
            cols.append((k, "N", 18, 6))
        else:
            width = max([len(str(v)) for v in vals if v is not None] + [1])
            cols.append((k, "C", min(max(width, 1), 254), 0))
    rec_size = 1 + sum(c[2] for c in cols)
    hdr_size = 32 + 32 * len(cols) + 1
    with open(base + ".dbf", "wb") as f:
        f.write(struct.pack("<B3BIHH20x", 0x03, 26, 7, 30, len(feats),
                            hdr_size, rec_size))
        for name, ftype, flen, fdec in cols:
            f.write(struct.pack("<11sc4xBB14x",
                                name.encode("ascii")[:10],
                                ftype.encode("ascii"), flen, fdec))
        f.write(b"\x0d")
        for feat in feats:
            props = feat.get("properties") or {}
            f.write(b" ")
            for name, ftype, flen, fdec in cols:
                v = props.get(name)
                if v is None:
                    cell = "?" if ftype == "L" else ""
                elif ftype == "L":
                    cell = "T" if v else "F"
                elif ftype == "N" and fdec:
                    cell = f"{float(v):.{fdec}f}"
                else:
                    cell = str(v)
                cell = cell[:flen]
                pad = (cell.rjust(flen) if ftype == "N"
                       else cell.ljust(flen))
                f.write(pad.encode("ascii", "replace"))
        f.write(b"\x1a")
