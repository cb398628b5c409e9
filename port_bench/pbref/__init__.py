"""The benchmark's plain reference: PyTorch and NumPy only.

Frozen copies of the scoring and genotyping arithmetic the program states
(the pair-HMM scan, the phasing priors of HP-tagged reads, the float64
posteriors and the VCF's genotype fields).  Nothing here imports the
program, JAX or the JAX package; the harness hands it the generated inputs
and the program's per-locus structure (trimmed and pooled reads,
candidate haplotypes) and compares what it computes with what the program
produced.
"""
