"""Haplotype blocks and the candidate-haplotype enumeration.

Reference: src/SeqAlignment/HapBlock.h, RepeatBlock.h, Haplotype.{h,cpp}.

A locus haplotype is a sequence of blocks [flank, repeat, flank, ...]; each
block has a reference sequence plus alternates.  The reference enumerates the
cartesian product with a reflected-Gray-code counter so only one block changes
per step (Haplotype.cpp:157-196) — that ordering defines the haplotype index
space used everywhere (hap_to_allele maps, log_aln_probs columns), so we
reproduce it exactly.  The column-reuse trick it enables is irrelevant on TPU
(all haplotypes are scored in one batch), but the *ordering* is semantic.
"""

from __future__ import annotations

from dataclasses import dataclass

from longtr_tpu_torch.models.stutter import StutterModel

# RepeatStutterInfo.h:10-11
MAX_STUTTER_REPEAT_INS = 6
MAX_STUTTER_REPEAT_DEL = -6
LARGE_NEGATIVE = -10e6


class HapBlock:
    """A haplotype block: ref sequence + alternates (HapBlock.h:18-163)."""

    def __init__(self, start: int, end: int, ref_seq: str):
        self.start = start
        self.end = end
        self.seqs = [ref_seq]
        self.inexact = [False]
        self._seq_set = {ref_seq}

    @property
    def repeat_info(self):
        return None

    def num_options(self) -> int:
        return len(self.seqs)

    def get_seq(self, idx: int) -> str:
        return self.seqs[idx]

    def get_inexact(self, idx: int) -> bool:
        return self.inexact[idx]

    def contains(self, seq: str) -> bool:
        return seq in self._seq_set

    def min_size(self) -> int:
        return min(len(s) for s in self.seqs)

    def max_size(self) -> int:
        return max(len(s) for s in self.seqs)

    def add_alternate(self, seq: str, inexact: bool = False):
        self.seqs.append(seq)
        self.inexact.append(inexact)
        self._seq_set.add(seq)

    def index_of(self, seq: str) -> int:
        return self.seqs.index(seq)

    def remove_alleles(self, allele_indices) -> "HapBlock":
        bad = set(allele_indices)
        assert 0 not in bad
        nb = HapBlock(self.start, self.end, self.seqs[0])
        for i in range(1, len(self.seqs)):
            if i not in bad:
                nb.add_alternate(self.seqs[i], self.inexact[i])
        return nb


class RepeatBlock(HapBlock):
    """Repeat block with stutter metadata (RepeatBlock.h, RepeatStutterInfo.h)."""

    def __init__(self, start: int, end: int, ref_seq: str, period: int,
                 stutter_model: StutterModel):
        super().__init__(start, end, ref_seq)
        self.period = period
        self.stutter_model = stutter_model.copy()
        self.max_ins = MAX_STUTTER_REPEAT_INS * period
        self.max_del = MAX_STUTTER_REPEAT_DEL * period

    @property
    def repeat_info(self):
        return self

    def log_prob_pcr_artifact(self, seq_index: int, artifact_size: int) -> float:
        """RepeatStutterInfo.h:53-61."""
        read_size = len(self.seqs[seq_index]) + artifact_size
        if artifact_size > 0 and artifact_size > self.max_ins:
            return LARGE_NEGATIVE
        if artifact_size < 0 and (artifact_size < self.max_del or read_size < 0):
            return LARGE_NEGATIVE
        return self.stutter_model.log_stutter_pmf(len(self.seqs[seq_index]), read_size)

    def remove_alleles(self, allele_indices) -> "RepeatBlock":
        bad = set(allele_indices)
        assert 0 not in bad
        nb = RepeatBlock(self.start, self.end, self.seqs[0], self.period,
                         self.stutter_model)
        for i in range(1, len(self.seqs)):
            if i not in bad:
                nb.add_alternate(self.seqs[i], self.inexact[i])
        return nb


@dataclass
class Haplotype:
    """Cartesian-product haplotype over blocks, reference iteration order."""

    blocks: list

    def __post_init__(self):
        self._configs = self._enumerate_configs()
        self._index = {tuple(c): i for i, c in enumerate(self._configs)}

    def num_blocks(self) -> int:
        return len(self.blocks)

    def num_combs(self) -> int:
        n = 1
        for b in self.blocks:
            n *= b.num_options()
        return n

    def num_options(self, block_index: int) -> int:
        return self.blocks[block_index].num_options()

    def get_block(self, i: int):
        return self.blocks[i]

    def _enumerate_configs(self):
        """Reflected-Gray-code order (Haplotype.cpp:123-196, inc_rev_=False).

        factors[i] = product of nopts[0..i-1]; at step t the changed block is
        the largest j (scanning from the last block backward) with
        t % factors[j] == 0; its count moves by a direction that flips at the
        boundaries.
        """
        nblocks = len(self.blocks)
        nopts = [b.num_options() for b in self.blocks]
        factors = []
        ncombs = 1
        for i in range(nblocks):
            factors.append(ncombs)
            ncombs *= nopts[i]
        counts = [0] * nblocks
        dirs = [1] * nblocks
        configs = [tuple(counts)]
        for t in range(1, ncombs):
            index = -1
            for j in range(nblocks - 1, -1, -1):
                if factors[j] == 0 or t % factors[j] == 0:
                    index = j
                    break
            counts[index] += dirs[index]
            if counts[index] == 0 or counts[index] == nopts[index] - 1:
                dirs[index] *= -1
            configs.append(tuple(counts))
        return configs

    def config(self, hap_index: int):
        """Block-option indices for one haplotype index."""
        return self._configs[hap_index]

    def hap_index(self, config) -> int:
        return self._index[tuple(config)]

    def all_configs(self):
        return self._configs

    def hap_seq(self, hap_index: int) -> str:
        cfg = self._configs[hap_index]
        return "".join(b.get_seq(c) for b, c in zip(self.blocks, cfg))

    def all_seqs(self):
        return [self.hap_seq(i) for i in range(self.num_combs())]

    def haps_to_alleles(self, block_index: int):
        """Per-haplotype option index of one block (seq_stutter_genotyper.cpp:240)."""
        return [cfg[block_index] for cfg in self._configs]

    def cur_size(self, hap_index: int) -> int:
        return len(self.hap_seq(hap_index))

    def max_size(self) -> int:
        return sum(b.max_size() for b in self.blocks)

    def print_block_structure(self, max_ref_len=35, max_other_len=100, logger=None):
        if logger is None:
            return
        max_rows = max(b.num_options() for b in self.blocks)
        lines = []
        for n in range(max_rows):
            row = []
            for b in self.blocks:
                limit = max_ref_len if b.num_options() == 1 else max_other_len
                if n < b.num_options():
                    s = b.get_seq(n)
                    if len(s) > limit:
                        v1 = limit // 2
                        v2 = limit - v1 - 3
                        s = s[:v1] + "..." + s[len(s) - v2:]
                    row.append(s.ljust(min(b.max_size(), limit) + 1))
                else:
                    row.append(" " * (min(b.max_size(), limit) + 1))
            lines.append("\t" + "".join(row))
        logger("\n".join(lines))
