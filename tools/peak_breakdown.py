#!/usr/bin/env python3
"""What holds a dry-run cell's peak: the live storages at the analyzer's
peak, grouped by the port function that made them.

    PYTHONPATH=src python3 tools/peak_breakdown.py ARCH SHAPE [MESH]

Builds the cell on ``meta`` as ``python -m repro_torch.launch.dryrun``
does (``launch.steps.lower_cell`` under the abstract production mesh,
``single_pod`` by default) with ``launch.op_analysis.OpAnalyzer``'s
liveness noted: each storage's bytes and the innermost port function on
the stack when it was made (``op_analysis.where``).  Prints the memory
record, then the live bytes by function at the peak (GiB, largest
first).  Needs no card; a train cell at the published widths takes a
minute or two.
"""
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import op_analysis as oa
    from repro_torch.launch.mesh import mesh_for
    from repro_torch.launch.steps import lower_cell
    arch, shape = argv[:2]
    mesh = argv[2] if len(argv) == 3 else "single_pod"
    made = {}                    # storage key -> (bytes, function)
    top = {"live": 0, "by": {}}
    register = oa.OpAnalyzer._register

    def noted(self, t, nbytes):
        new = register(self, t, nbytes)
        if new:
            made[t.untyped_storage()._cdata] = (nbytes, oa.where())
            if self.live > top["live"]:
                by = collections.Counter()
                for key in self._bytes:
                    if key in made:
                        by[made[key][1]] += made[key][0]
                top.update(live=self.live, by=by)
        return new

    oa.OpAnalyzer._register = noted
    try:
        cell = lower_cell(get_config(arch), get_shape(shape),
                          mesh_for(mesh, abstract=True))
    finally:
        oa.OpAnalyzer._register = register
    print(f"{arch} x {shape} x {mesh}: {cell['memory']}")
    for where, n in top["by"].most_common(12):
        print(f"{n / 2 ** 30:9.2f} GiB  {where}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
