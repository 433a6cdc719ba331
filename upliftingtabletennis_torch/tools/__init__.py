"""Measurement tools of the port: the phase probes of K1 and K2 (`probe_attn_phases`,
`probe_ffn_phases`), counterparts of the JAX package's `tools/probe_*_phases.py`; the tile
product's phases (`gemm_phases`); and `extract_model_from_latest`, the uplifting trainer's
`latest` snapshot written as a loadable `model` checkpoint."""
