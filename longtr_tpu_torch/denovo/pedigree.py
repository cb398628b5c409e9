"""Pedigree parsing and nuclear-family extraction.

Reference: src/pedigree.{h,cpp} — FAM file → pedigree DAG → prune to samples
with data → split into connected components → keep those that are simple
nuclear families (two founders, all children shared).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class NuclearFamily:
    family_id: str
    mother: str
    father: str
    children: list

    @property
    def samples(self):
        return [self.mother, self.father] + list(self.children)

    def size(self):
        return 2 + len(self.children)

    def num_children(self):
        return len(self.children)

    def is_missing_sample(self, samples: set) -> bool:
        return any(s not in samples for s in self.samples)

    def is_missing_genotype(self, variant) -> bool:
        return any(variant.genotype(s) is None for s in self.samples)

    def is_mendelian(self, variant) -> bool:
        """pedigree.h:71-88."""
        gm = variant.genotype(self.mother)
        gf = variant.genotype(self.father)
        if gm is None or gf is None:
            return False
        m1, m2, _ = gm
        f1, f2, _ = gf
        for child in self.children:
            gc = variant.genotype(child)
            if gc is None:
                return False
            c1, c2, _ = gc
            ok_a = (c1 in (m1, m2)) and (c2 in (f1, f2))
            ok_b = (c1 in (f1, f2)) and (c2 in (m1, m2))
            if not (ok_a or ok_b):
                return False
        return True


@dataclass
class _Node:
    name: str
    family: str
    mother: "_Node" = None
    father: "_Node" = None
    children: list = field(default_factory=list)


def _read_fam(path: str):
    """FAM parse (pedigree.cpp:64-121 PedigreeGraph::build).

    Reference semantics mirrored exactly, order included:
    - every line must yield >=4 whitespace tokens (family child father
      mother); a blank or short line is a format error, extra columns
      (sex/phenotype) are ignored;
    - nodes are created in first-appearance order, per line in child ->
      mother -> father order;
    - a repeated child line OVERWRITES mother/father but appends to the
      parents' children lists unconditionally (duplicates accumulate —
      the later topological sort dies on them, like the reference);
    - family-id consistency is re-checked against each line for all three
      named samples.
    """
    nodes = {}
    order = []

    def get(name, family):
        if name not in nodes:
            nodes[name] = _Node(name, family)
            order.append(nodes[name])
        return nodes[name]

    with open(path) as fh:
        for line in fh:
            f = line.split()
            if len(f) < 4:
                raise ValueError(
                    f"Improperly formated .ped pedigree file {path}")
            family, child, father, mother = f[0], f[1], f[2], f[3]
            if child == "0":
                raise ValueError(f"Invalid individual id {child}")
            cn = get(child, family)
            mn = get(mother, family) if mother != "0" else None
            fn = get(father, family) if father != "0" else None
            for n in (cn, mn, fn):
                if n is not None and n.family != family:
                    raise ValueError(
                        "Inconsistent family IDs detected in FAM file for "
                        f"sample {n.name}")
            cn.mother = mn
            cn.father = fn
            if mn:
                mn.children.append(cn)
            if fn:
                fn.children.append(cn)
    return order


def _topological_sort(nodes):
    """pedigree.cpp:26-62 PedigreeGraph::topological_sort.

    Returns the topologically ordered node list, or None if the graph has a
    cycle (unprocessed parented nodes remain).  Raises on the reference's
    "Logical error" path: meeting a child that is absent from parent_counts
    (happens when duplicate FAM lines left stale entries in a parent's
    children list)."""
    counts = {}
    sources = []
    for n in nodes:
        c = int(n.mother is not None) + int(n.father is not None)
        if c == 0:
            sources.append(n)
        else:
            counts[id(n)] = c
    out = []
    while sources:
        s = sources.pop()
        out.append(s)
        for c in s.children:
            if id(c) not in counts:
                raise ValueError(
                    "Logical error in topological_sort() for parent "
                    f"{s.name} and child {c.name}")
            if counts[id(c)] == 1:
                sources.append(c)
                del counts[id(c)]
            else:
                counts[id(c)] -= 1
    return None if counts else out


def _prune(topo_nodes, sample_set: set):
    """pedigree.cpp:125-175 PedigreeGraph::prune.

    Operates on the topologically sorted node list: forward pass marks nodes
    with a requested sample at-or-above, backward pass at-or-below; nodes
    lacking either are removed with order-preserving compaction, and
    surviving nodes drop pointers to removed parents/children."""
    upstream = {}
    for n in topo_nodes:
        up = n.name in sample_set
        up |= bool(n.father is not None and upstream[id(n.father)])
        up |= bool(n.mother is not None and upstream[id(n.mother)])
        upstream[id(n)] = up
    downstream = {}
    for n in reversed(topo_nodes):
        down = n.name in sample_set
        for c in n.children:
            down |= downstream[id(c)]
        downstream[id(n)] = down
    removed = {id(n): not (upstream[id(n)] and downstream[id(n)])
               for n in topo_nodes}
    keep = []
    for n in topo_nodes:
        if removed[id(n)]:
            continue
        if n.father is not None and removed[id(n.father)]:
            n.father = None
        if n.mother is not None and removed[id(n.mother)]:
            n.mother = None
        n.children = [c for c in n.children if not removed[id(c)]]
        keep.append(n)
    return keep


def _components(topo_nodes):
    """pedigree.cpp:236-270 split_into_connected_components: seeds iterate
    the (pruned) topological order; DFS pops from the back of a stack onto
    which mother, father, then children are pushed, with a visited re-check
    at pop time.  Component node order is DFS discovery order."""
    seen = set()
    comps = []
    for n in topo_nodes:
        if id(n) in seen:
            continue
        comp = []
        stack = [n]
        while stack:
            cur = stack.pop()
            if id(cur) in seen:
                continue
            seen.add(id(cur))
            comp.append(cur)
            if cur.mother is not None and id(cur.mother) not in seen:
                stack.append(cur.mother)
            if cur.father is not None and id(cur.father) not in seen:
                stack.append(cur.father)
            for c in cur.children:
                if id(c) not in seen:
                    stack.append(c)
        comps.append(comp)
    return comps


def _subgraph_topo(comp):
    """pedigree.cpp:177-234 build_subgraph: clone the component's nodes in
    DFS-discovery iteration order (child, then mother, then father per
    visited node) and topologically sort the clones.  The resulting order —
    not file order — determines founder and child ordering in the emitted
    NuclearFamily, so it must be reproduced exactly."""
    clones = {}
    order = []

    def get(name, family):
        if name not in clones:
            clones[name] = _Node(name, family)
            order.append(clones[name])
        return clones[name]

    for n in comp:
        cn = get(n.name, n.family)
        mn = get(n.mother.name, n.family) if n.mother is not None else None
        fn = get(n.father.name, n.family) if n.father is not None else None
        cn.mother = mn
        cn.father = fn
        if mn is not None:
            mn.children.append(cn)
        if fn is not None:
            fn.children.append(cn)
    topo = _topological_sort(order)
    if topo is None:
        raise ValueError("Subgraph in pedigree contains a cycle")
    return topo


def _as_nuclear_family(comp):
    """pedigree.cpp:272-307 is_nuclear_family + convert_to_nuclear_family,
    evaluated on the rebuilt per-component subgraph: exactly two founders,
    >=1 leaf, founders+leaves == all nodes, every leaf parented by both
    founders; children emitted in subgraph topological order."""
    topo = _subgraph_topo(comp)
    founders = [n for n in topo if n.mother is None and n.father is None]
    leaves = [n for n in topo if not n.children]
    if len(founders) != 2 or not leaves or \
            len(founders) + len(leaves) != len(topo):
        return None
    p1, p2 = founders[0].name, founders[1].name
    for leaf in leaves:
        if leaf.mother is None or leaf.father is None:
            return None
        m, f = leaf.mother.name, leaf.father.name
        if not ((m == p1 and f == p2) or (m == p2 and f == p1)):
            return None
    mother = leaves[0].mother.name
    father = leaves[0].father.name
    return NuclearFamily(leaves[0].family, mother, father,
                         [n.name for n in leaves])


def extract_pedigree_nuclear_families(fam_file: str, samples_with_data: set,
                                      logger=None):
    """pedigree.cpp:309-333. Returns list[NuclearFamily] in the reference's
    order (components seeded from the pruned topological order)."""
    nodes = _read_fam(fam_file)
    topo = _topological_sort(nodes)
    if topo is None:
        raise ValueError(
            f"Supplied pedigree file {fam_file} contains cycles")
    pruned = _prune(topo, samples_with_data)
    families = []
    num_others = 0
    for comp in _components(pruned):
        fam = _as_nuclear_family(comp)
        if fam is not None:
            families.append(fam)
        else:
            num_others += 1
    if logger:
        logger(f"Detected {len(families)} nuclear families and {num_others} "
               f"other family structures")
    return families
