"""faucet_tpu — a streaming de Bruijn graph assembler for one accelerator
or a mesh of them.

A from-scratch JAX/XLA re-design of the capabilities of
Shamir-Lab/Faucet (Rozov et al., Bioinformatics 2018): single-pass
compacted-de-Bruijn-graph construction from read streams with a two-level
Bloom-filter cascade, explicit junction detection, implicit linear paths,
graph cleaning, and contigs/GFA emission.

Reference provenance: the reference mount was empty during survey and build
(SURVEY.md §0); parity targets follow the behavioral spec in SURVEY.md §A.
Where this framework intentionally diverges from the reference's CPU design
(dense batched scanning instead of junction-hopping, 8 canonical-orientation
slots instead of 5 read-orientation slots), the divergence is documented in
the relevant module docstring.
"""

from faucet_tpu.version import __version__  # noqa: F401
from faucet_tpu.config import Config  # noqa: F401
