"""volcanosv_tpu — a GPU-accelerated diploid structural-variant engine.

A from-scratch reimplementation of the capabilities of VolcanoSV
(maiziezhoulab/VolcanoSV) as a single JAX/XLA framework:

* SNP calling + read-backed phasing      (replaces longshot;      ref: bin/VolcanoSV-asm/volcanosv-asm.py:75-80)
* k-mer haplotype partitioning of reads  (replaces L2 scripts;    ref: bin/VolcanoSV-asm/unphased_reads_assignment_kmer_norm.py)
* local de novo assembly per phase block (replaces hifiasm/flye;  ref: bin/VolcanoSV-asm/General_Assembly_Workflow.py)
* contig→reference alignment             (replaces minimap2;      ref: bin/VolcanoSV-vc/Large_INDEL/Raw_variant_call.py:46-58)
* large-indel calling                    (ref: bin/VolcanoSV-vc/Large_INDEL/extract_contig_signature_Hifi.py)
* small-indel calling                    (replaces htsbox+dipcall; ref: bin/VolcanoSV-vc/Small_INDEL/)
* complex SV calling (DUP/INV/TRA)       (replaces svim-asm;      ref: bin/VolcanoSV-vc/Complex_SV/)

Compute-dense inner loops run on the accelerator (jitted XLA, and a CUDA
banded-DP kernel on the GPU); host code does streaming I/O, seeding and
ragged-batch marshalling.
"""
import os

__version__ = "0.1.0"

# JAX's persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR
# itself; without it the cache lives at this fixed path inside the checkout
# (git-ignored), so every process of a checkout shares one cache.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def configure_compile_cache() -> str | None:
    """Point JAX's compilation cache at CACHE_DIR unless the environment
    names one.  Returns the directory set here, or None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CACHE_DIR


configure_compile_cache()
