"""The roofline's work: the frozen tables are what the reference's code
counts to, and the per-node table gives the reference scene's hand count."""

import json

from portbench.core import manifest, roofline
from portbench.work import count


def test_reference_scene_hand_count():
    # plane: 3 products, 2 adds, 1 subtract; sphere: 3 subtracts, 3 squares,
    # 2 adds, a square root (one FP32 and one special-function operation),
    # 1 subtract; the union's min: 17 FP32 and 1 special-function operation
    # an evaluation, every operand evaluated.
    spec = manifest.config(manifest.load(), "reference")["scene"]
    assert roofline.scene_cost(spec)["eval"] == (6 + 10 + 1, 1)


def test_frozen_node_tables_match_the_reference():
    for op, want in count.node_costs().items():
        assert json.loads((roofline.WORK / "nodes" / f"{op}.json").read_text()) == want, op


def test_frozen_phase_table_matches_the_reference():
    assert json.loads((roofline.WORK / "phases.json").read_text()) == count.phase_costs()


def test_bounds_grow_with_the_marches():
    spec = manifest.config(manifest.load(), "fractal")["scene"]
    few = {"pixels": 100, "primary": 1000, "shadow": 500}
    many = {"pixels": 100, "primary": 2000, "shadow": 500}
    assert roofline.k1_bound_s(spec, many, 8) > roofline.k1_bound_s(spec, few, 8) > 0
    assert roofline.k3_bound_s(spec, few, 8) > roofline.k1_bound_s(spec, few, 8)
