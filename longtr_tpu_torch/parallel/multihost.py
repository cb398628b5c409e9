"""Multi-host scale-out: locus sharding + rank-0 VCF merge.

The reference's only scale-out is manual BED splitting across processes
(README.md:78-82).  Here sharding is first-class: each host processes a
deterministic interleaved shard of the (sorted) catalog — interleaving
balances load because neighboring loci have correlated read depth — and the
rank-0 merge heap-merges the per-shard bgzipped VCFs into one sorted stream.

Used by ``longtr --shard K/N`` and ``longtr-merge-vcf``.  On a JAX
multi-process deployment the same two functions back a
``jax.distributed``-initialized run (shard by ``jax.process_index()``,
merge on process 0).
"""

from __future__ import annotations

import heapq
import sys

from longtr_tpu_torch.io.bgzf import BgzfWriter, bgzf_open_text


def shard_regions(regions, num_shards: int, shard_id: int,
                  mode: str = "interleave"):
    """Deterministic shard of a sorted region list.

    ``interleave`` (default) takes every num_shards-th region — best load
    balance for small catalogs.  ``block`` takes a contiguous balanced
    chunk — at catalog scale adjacent loci share BAM windows and FASTA
    chromosomes, so block shards keep each host's IO proportional to its
    share (interleaved shards touch nearly every window/chromosome of the
    whole catalog; measured 0.52 vs ~1.0 two-host scaling efficiency at
    10k loci, benchmarks/scaling_efficiency.py).  Merged output is
    byte-identical either way (per-locus records are independent; tests
    enforce)."""
    if not (0 <= shard_id < num_shards):
        raise ValueError("shard_id must be in [0, num_shards)")
    if mode == "block":
        n = len(regions)
        lo = shard_id * n // num_shards
        hi = (shard_id + 1) * n // num_shards
        return list(regions[lo:hi])
    if mode != "interleave":
        raise ValueError(f"unknown shard mode {mode!r}")
    return [r for i, r in enumerate(regions) if i % num_shards == shard_id]


def merge_sorted_vcfs(paths, out_path: str):
    """Heap-merge per-shard VCFs (identical headers) into one sorted VCF."""
    readers = []
    header = None
    for p in paths:
        fh = bgzf_open_text(p) if p.endswith(".gz") else open(p)
        lines = iter(fh)
        hdr = []
        first = None
        for line in lines:
            if line.startswith("#"):
                hdr.append(line)
            else:
                first = line
                break
        if header is None:
            header = hdr
        readers.append((lines, first))

    out = BgzfWriter(out_path)
    for line in header or []:
        out.write(line)

    # Order must match the single-run emission order: regions are processed
    # in lexicographic (chrom, start) order (regions.sort_key, mirroring the
    # reference's orderRegions), NOT ##contig/FASTA order — the two diverge
    # past 9 chromosomes ("chr126" < "chr13" lexicographically).
    def key(line):
        chrom, pos = line.split("\t", 2)[:2]
        return (chrom, int(pos))

    heap = []
    for idx, (lines, first) in enumerate(readers):
        if first is not None:
            heapq.heappush(heap, (key(first), idx, first))
    readers = [r[0] for r in readers]
    while heap:
        _, idx, line = heapq.heappop(heap)
        out.write(line)
        nxt = next(readers[idx], None)
        if nxt is not None:
            heapq.heappush(heap, (key(nxt), idx, nxt))
    out.close()


def merge_text_blocks(paths, out_path: str, bgzf: bool = True):
    """Heap-merge per-shard locus-keyed text files (viz / stutter models).

    Lines are grouped into blocks of consecutive identical (chrom, pos) keys
    (pos = 2nd tab field); blocks are merged by key with the within-block
    line order preserved (unlike the per-line VCF merge, one locus spans
    several lines here).  Loci are disjoint across shards, so block order is
    total.
    """
    def key(line):
        chrom, pos = line.split("\t", 2)[:2]
        return (chrom, int(pos))

    def blocks(path):
        fh = bgzf_open_text(path) if path.endswith(".gz") else open(path)
        block, bkey = [], None
        for line in fh:
            if not line.strip():
                continue
            k = key(line)
            if bkey is not None and k != bkey:
                yield bkey, block
                block = []
            bkey = k
            block.append(line)
        if block:
            yield bkey, block
        fh.close()

    out = BgzfWriter(out_path) if bgzf else open(out_path, "w")
    iters = [blocks(p) for p in paths]
    heap = []
    for idx, it in enumerate(iters):
        first = next(it, None)
        if first is not None:
            heapq.heappush(heap, (first[0], idx, first[1]))
    while heap:
        _, idx, block = heapq.heappop(heap)
        for line in block:
            out.write(line)
        nxt = next(iters[idx], None)
        if nxt is not None:
            heapq.heappush(heap, (nxt[0], idx, nxt[1]))
    out.close()


def merge_main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="longtr-merge-vcf",
        description="Merge per-shard LongTR VCFs into one sorted bgzipped VCF")
    p.add_argument("--out", required=True)
    p.add_argument("vcfs", nargs="+")
    args = p.parse_args(argv)
    merge_sorted_vcfs(args.vcfs, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(merge_main())
