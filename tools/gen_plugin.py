#!/usr/bin/env python3
"""Generate the WIPP plugin manifest (plugin.json) from the live taxonomy.

Mirrors the reference's plugin.json (reference: plugin.json:1 — a WIPP
manifest exposing segDir/intDir/filePattern/features/outputType/... inputs
and a csvCollection output); feature options come from the registered group
nicknames so the manifest never drifts from the engine.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nyxus_tpu import taxonomy as tx  # noqa: E402


def main():
    groups = (sorted(tx.GROUP2D) + sorted(tx.GROUP3D) + sorted(tx.GROUPIMQ))
    feature_opts = [{"description": g.strip("*"), "enum": [g]}
                    for g in groups]
    manifest = {
        "name": "NyxusTPU",
        "version": "0.4.0",
        "containerId": "nyxus-tpu:0.4.0",
        "title": "Nyxus-TPU feature extraction",
        "description": "Scalable image feature extraction on JAX accelerators "
                       "(Nyxus-compatible feature set and output contract)",
        "author": "",
        "institution": "",
        "repository": "",
        "website": "",
        "citation": "",
        "inputs": [
            {"name": "segDir", "description": "Labeled image collection",
             "type": "collection", "options": None, "required": False},
            {"name": "intDir", "description": "Intensity image collection",
             "type": "collection", "options": None, "required": False},
            {"name": "filePattern",
             "description": "Regular expression to filter file names",
             "type": "string", "options": None, "required": True},
            {"name": "pixelDistance",
             "description": "Pixel distance for neighbor features",
             "type": "integer", "options": None, "required": False},
            {"name": "features", "description": "Features to extract",
             "type": "array",
             "options": {"items": {"type": "string",
                                   "title": "Select feature",
                                   "oneOf": feature_opts}},
             "required": True},
            {"name": "outputType",
             "description": "Output format",
             "type": "enum",
             "options": {"values": ["separatecsv", "singlecsv", "arrowipc",
                                    "parquet"]},
             "required": True},
            {"name": "coarseGrayDepth",
             "description": "Grey depth for texture families",
             "type": "integer", "options": None, "required": False},
            {"name": "pixelsPerCentimeter",
             "description": "Resolution for calibrated outputs",
             "type": "number", "options": None, "required": False},
            {"name": "ibsi", "description": "IBSI-compliant mode",
             "type": "boolean", "options": None, "required": False},
            {"name": "dim", "description": "2 (slides) or 3 (volumes)",
             "type": "integer", "options": None, "required": False},
        ],
        "outputs": [
            {"name": "outDir", "description": "Output collection",
             "type": "csvCollection", "options": None, "required": True},
        ],
        "ui": [{"key": "inputs.%s" % i["name"],
                "title": i["name"],
                "description": i["description"]}
               for i in []],
    }
    manifest["ui"] = [{"key": "inputs.%s" % i["name"], "title": i["name"],
                       "description": i["description"]}
                      for i in manifest["inputs"]]
    out = os.path.join(ROOT, "plugin.json")
    with open(out, "w") as f:
        json.dump(manifest, f, indent=2)
        f.write("\n")
    print("wrote", out, "(%d feature group options)" % len(feature_opts))


if __name__ == "__main__":
    main()
