"""The float64 twin of the Cook_E2 production run: setup_cooke2 as it is,
in float64, into results/Cook_E2_370kpa_f64 (the report's second
directory).

    SHAKTI_MESH_DIR=assets/cooke2_synth python -m shakti_tpu_torch \
        scripts/torch_setup_cooke2_f64.py
"""

import torch

from shakti_tpu_torch.setups import setup_cooke2


def initialize():
    md = setup_cooke2.initialize(results_name="results/Cook_E2_370kpa_f64")
    md.dtype = torch.float64
    return md
