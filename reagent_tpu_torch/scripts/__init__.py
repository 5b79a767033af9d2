"""Scripts (port of ``reagent_tpu/scripts/``)."""
