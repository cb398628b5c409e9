"""The port's copies of the console tools and fixture builders against the
JAX package's, on the CPU.

Each tool gets the inputs that tests/test_denovo.py, tests/test_aux_tools.py
and tests/test_viz_ref_tooling.py give the JAX package's tool, and the two
packages' tools run in turn on the same paths (some tools write their
command line into their output): the outputs must be equal byte for byte
(a bgzipped output compressed block for block, so its file bytes too).  The
fixture builders of ``longtr_tpu_torch.testing`` must write the bytes of
tests/synth.py, ``__graft_entry__._dryrun_catalog`` and
``benchmarks/loci_throughput.build_catalog`` for the same seed.
"""

import gzip
import importlib.util
import io
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from synth import standard_fixture  # noqa: E402
from test_denovo import write_fam, write_trio_str_vcf  # noqa: E402

from longtr_tpu.io.bgzf import BgzfWriter  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_bgzf(path, lines):
    w = BgzfWriter(path)
    w.write("\n".join(lines) + "\n")
    w.close()
    return path


def _trio_snps(path, seed, n, phased_kid):
    """A phased trio SNP VCF (MOM DAD KID) with consistent transmission."""
    rng = np.random.default_rng(seed)
    lines = ["##fileformat=VCFv4.1",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tMOM\t"
             "DAD\tKID"]
    pos = 500
    for _ in range(n):
        pos += int(rng.integers(30, 80))
        dad = (int(rng.integers(2)), int(rng.integers(2)))
        kid = phased_kid(dad)
        lines.append(f"chr1\t{pos}\tsnp{pos}\tA\tG\t.\t.\t.\tGT\t0|1\t"
                     f"{dad[0]}|{dad[1]}\t{kid[0]}|{kid[1]}")
    return _write_bgzf(path, lines), pos


@pytest.fixture(scope="module")
def longtr_outputs(tmp_path_factory):
    """A VCF and a --viz-out file of the JAX package's longtr on the synth
    fixture: inputs of filter_vcf, merge and vizaln."""
    from longtr_tpu.cli import main
    tmp = tmp_path_factory.mktemp("longtr")
    fx = standard_fixture(str(tmp))
    vcf, viz = str(tmp / "calls.vcf.gz"), str(tmp / "alns.html.gz")
    assert main(["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
                 "--regions", fx["bed"], "--tr-vcf", vcf, "--viz-out", viz,
                 "--min-reads", "5", "--quiet"]) == 0
    return dict(vcf=vcf, viz=viz)


def _denovo_trio(tmp, pkg):
    """DenovoFinder, trio mode (test_denovo.test_trio_denovo_mutation)."""
    mod = importlib.import_module(f"{pkg}.denovo.cli")
    str_vcf = str(tmp / "str.vcf.gz")
    write_trio_str_vcf(str_vcf, {"MOM": (0, 1), "DAD": (0, 1), "KID": (0, 2)})
    fam = write_fam(tmp / "trio.fam")
    out = str(tmp / "out.vcf.gz")
    assert mod.main(["--fam", fam, "--str-vcf", str_vcf, "--denovo-vcf", out,
                     "--uniform-prior", "--log", str(tmp / "out.log")]) == 0
    return [out, out + ".tbi"]


def _denovo_joint(tmp, pkg):
    """DenovoFinder, family-joint mode with SNP transmission
    (test_denovo.test_joint_scanner_with_snp_transmission)."""
    mod = importlib.import_module(f"{pkg}.denovo.cli")
    str_vcf = str(tmp / "str.vcf.gz")
    write_trio_str_vcf(str_vcf, {"MOM": (0, 1), "DAD": (0, 0), "KID": (1, 0)},
                       gl_field="PHASEDGL")
    fam = write_fam(tmp / "trio.fam")
    snp, _ = _trio_snps(str(tmp / "snps.vcf.gz"), 3, 600,
                        lambda dad: (1, dad[0]))
    out = str(tmp / "out.vcf.gz")
    assert mod.main(["--fam", fam, "--str-vcf", str_vcf, "--denovo-vcf", out,
                     "--snp-vcf", snp, "--uniform-prior",
                     "--log", str(tmp / "out.log")]) == 0
    return [out, out + ".tbi"]


def _phasingchecker(tmp, pkg):
    """PhasingChecker (test_aux_tools.test_phasingchecker)."""
    mod = importlib.import_module(f"{pkg}.denovo.phasing_checker")
    snp, pos = _trio_snps(str(tmp / "snps.vcf.gz"), 4, 500,
                          lambda dad: (1, dad[0]))
    fam = str(tmp / "t.fam")
    with open(fam, "w") as fh:
        fh.write("F1\tKID\tDAD\tMOM\n")
    bed = str(tmp / "r.bed")
    with open(bed, "w") as fh:
        fh.write(f"chr1\t{pos // 2}\t{pos // 2 + 20}\tAC\tL1\n")
    out = str(tmp / "out.dist.gz")
    assert mod.main(["--fam", fam, "--snp-vcf", snp, "--regions", bed,
                     "--out", out]) == 0
    return [out]


def _filter_vcf(tmp, pkg, longtr):
    """longtr-filter-vcf on a longtr VCF, call and locus filters on."""
    mod = importlib.import_module(f"{pkg}.scripts.filter_vcf")
    out, log = io.StringIO(), io.StringIO()
    assert mod.main(["--vcf", longtr["vcf"], "--min-call-depth", "8",
                     "--min-call-qual", "0.5", "--max-call-stutter", "0.3",
                     "--min-loc-depth", "20"], out=out, log=log) == 0
    return [out.getvalue(), log.getvalue()]


def _annotate_denovo(tmp, pkg):
    """longtr-annotate-denovo (test_aux_tools.test_annotate_denovo)."""
    dn = importlib.import_module(f"{pkg}.denovo.cli")
    ann = importlib.import_module(f"{pkg}.scripts.annotate_denovo")
    str_vcf = str(tmp / "str.vcf.gz")
    write_trio_str_vcf(str_vcf, {"MOM": (0, 1), "DAD": (0, 1), "KID": (0, 2)})
    fam = write_fam(tmp / "trio.fam")
    dn_vcf = str(tmp / "dn.vcf.gz")
    assert dn.main(["--fam", fam, "--str-vcf", str_vcf, "--denovo-vcf",
                    dn_vcf, "--uniform-prior",
                    "--log", str(tmp / "out.log")]) == 0
    buf = io.StringIO()
    assert ann.main(["--vcf", str_vcf, "--denovo-ll-vcf", dn_vcf],
                    out=buf) == 0
    return [buf.getvalue()]


def _get_stutter_models(tmp, pkg):
    """getstuttermodels (test_aux_tools.test_getstuttermodels)."""
    mod = importlib.import_module(f"{pkg}.scripts.get_stutter_models")
    vcf = _write_bgzf(str(tmp / "h.vcf.gz"), [
        "##fileformat=VCFv4.1",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO",
        "chr1\t100\t.\tACAC\tACACAC\t.\t.\tSTART=100;END=110;PERIOD=2;"
        "INFRAME_PGEOM=0.95;INFRAME_DOWN=0.001;INFRAME_UP=0.05;"
        "OUTFRAME_PGEOM=0.9;OUTFRAME_DOWN=0.02;OUTFRAME_UP=0.005",
        "chr2\t500\t.\tAAT\tAATAAT\t.\t.\tSTART=500;END=520;PERIOD=3;"
        "INFRAME_PGEOM=0.8;INFRAME_DOWN=0.2;INFRAME_UP=0.03;"
        "OUTFRAME_PGEOM=0.7;OUTFRAME_DOWN=0.04;OUTFRAME_UP=0.03"])
    buf = io.StringIO()
    assert mod.main([vcf], out=buf) == 0
    return [buf.getvalue()]


def _merge(tmp, pkg, longtr):
    """longtr-merge-vcf (multihost.merge_main) of a VCF split into two
    interleaved shards."""
    from longtr_tpu.io.bgzf import bgzf_open_text
    mod = importlib.import_module(f"{pkg}.parallel.multihost")
    with bgzf_open_text(longtr["vcf"]) as fh:
        lines = fh.read().splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    body = [ln for ln in lines if not ln.startswith("#")]
    assert len(body) >= 4
    shards = [_write_bgzf(str(tmp / f"s{k}.vcf.gz"), head + body[k::2])
              for k in range(2)]
    out = str(tmp / "merged.vcf.gz")
    assert mod.merge_main(["--out", out, *shards]) == 0
    return [out]


def _vizaln(tmp, pkg, longtr):
    """vizaln: the first locus of a --viz-out file as HTML."""
    mod = importlib.import_module(f"{pkg}.pipeline.viz")
    html = str(tmp / "out.html")
    assert mod.main([longtr["viz"], "chr1", "1001", "--out", html]) == 0
    return [html]


TOOLS = {"denovofinder_trio": _denovo_trio,
         "denovofinder_joint": _denovo_joint,
         "phasingchecker": _phasingchecker,
         "filter_vcf": _filter_vcf,
         "annotate_denovo": _annotate_denovo,
         "get_stutter_models": _get_stutter_models,
         "merge_vcf": _merge,
         "vizaln": _vizaln}


def _contents(outputs):
    """File bytes of each output path (a tabix index decompressed: its
    gzip header carries the time it was written), or the captured text."""
    got = []
    for o in outputs:
        if isinstance(o, str) and os.path.isabs(o):
            with open(o, "rb") as fh:
                data = fh.read()
            got.append(gzip.decompress(data) if o.endswith(".tbi") else data)
        else:
            got.append(o)
    return got


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_output_identical(tool, tmp_path, request):
    fn = TOOLS[tool]
    extra = ([request.getfixturevalue("longtr_outputs")]
             if fn.__code__.co_argcount == 3 else [])
    outs = {}
    for pkg in ("longtr_tpu", "longtr_tpu_torch"):
        # the same paths for both, so that the command lines that tools
        # write into their headers agree; read before the next run
        outs[pkg] = _contents(fn(tmp_path, pkg, *extra))
        for f in tmp_path.iterdir():
            f.unlink()
    assert len(outs["longtr_tpu"][0]) > 20, tool
    assert outs["longtr_tpu_torch"] == outs["longtr_tpu"], tool


def _tree_bytes(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _loci_throughput():
    spec = importlib.util.spec_from_file_location(
        "loci_throughput", os.path.join(REPO, "benchmarks",
                                        "loci_throughput.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BUILDERS = ["standard_fixture", "dryrun_catalog", "str_catalog",
            "vntr_catalog"]


@pytest.mark.parametrize("builder", BUILDERS)
def test_fixture_builders_write_same_bytes(builder, tmp_path):
    """longtr_tpu_torch.testing writes, for the same seed, the files of the
    pre-port builders that the smoke's numbers were taken on."""
    from longtr_tpu_torch.testing import catalogs
    from longtr_tpu_torch.testing import synth as port_synth
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    if builder == "standard_fixture":
        standard_fixture(str(a), rng=np.random.default_rng(3))
        port_synth.standard_fixture(str(b), rng=np.random.default_rng(3))
    elif builder == "dryrun_catalog":
        sys.path.insert(0, REPO)
        from __graft_entry__ import _dryrun_catalog
        want = _dryrun_catalog(str(a))
        got = catalogs.dryrun_catalog(str(b))
        assert got["n_loci"] == want["n_loci"] == 24
    else:
        kw = dict(vntr=True) if builder == "vntr_catalog" else {}
        n = 3 if kw else 12
        want = _loci_throughput().build_catalog(str(a), n, seed=1, **kw)
        got = catalogs.build_catalog(str(b), n, seed=1, **kw)
        assert got[4] == want[4]
    want_files, got_files = _tree_bytes(a), _tree_bytes(b)
    assert len(want_files) >= 4
    assert got_files.keys() == want_files.keys()
    for name in want_files:
        assert got_files[name] == want_files[name], name
