"""Dense decoder-only LM of the port (``repro.models`` minus MLA, MoE and
SSM mixers)."""
