"""Structurally-faithful raw task-DAG generators for the ten WfCommons
workflow families used in the paper (Table 8).

WfInstances JSON traces are not available offline; these generators
reproduce the documented fan-out/fan-in topology, depth and width
statistics of each family (WfCommons, Coleman et al. 2022).  The paper
itself uses WfCommons "as a source of realistic dependency structure
rather than as a direct trace" (Appendix C.1), which is exactly what
these provide.  Everything is deterministic in (family, instance seed).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable


@dataclasses.dataclass
class RawTask:
    tid: str
    name_family: str               # normalized task-name prefix
    parents: list[str]


RawDag = dict[str, RawTask]


def _t(dag: RawDag, family: str, idx: int,
       parents: list[str]) -> str:
    tid = f"{family}_{idx:05d}"
    dag[tid] = RawTask(tid, family, list(parents))
    return tid


def gen_1000genome(rng: random.Random) -> RawDag:
    dag: RawDag = {}
    n_ind = rng.randint(16, 56)
    inds = [_t(dag, "individuals", i, []) for i in range(n_ind)]
    merge = _t(dag, "individuals_merge", 0, inds)
    sift = _t(dag, "sifting", 0, [])
    n_an = rng.randint(8, 24)
    for i in range(n_an):
        _t(dag, "mutation_overlap", i, [merge, sift])
    for i in range(n_an):
        _t(dag, "frequency", i, [merge, sift])
    return dag


def gen_blast(rng: random.Random) -> RawDag:
    dag: RawDag = {}
    split = _t(dag, "split_fasta", 0, [])
    n = rng.randint(24, 96)
    blasts = [_t(dag, "blastall", i, [split]) for i in range(n)]
    cat = _t(dag, "cat_blast", 0, blasts)
    _t(dag, "postprocess", 0, [cat])
    return dag


def gen_bwa(rng: random.Random) -> RawDag:
    dag: RawDag = {}
    idx = _t(dag, "bwa_index", 0, [])
    red = _t(dag, "fastq_reduce", 0, [])
    n = rng.randint(24, 80)
    aligns = [_t(dag, "bwa_align", i, [idx, red]) for i in range(n)]
    cat = _t(dag, "cat_bwa", 0, aligns)
    _t(dag, "cat_all", 0, [cat])
    return dag


def gen_cycles(rng: random.Random) -> RawDag:
    dag: RawDag = {}
    n_params = rng.randint(6, 14)
    outs = []
    for p in range(n_params):
        base = _t(dag, "baseline_cycles", p, [])
        cy = _t(dag, "cycles", p, [base])
        fi = _t(dag, "fertilizer_increase", p, [cy])
        outs.append(_t(dag, "cycles_output_parser", p, [fi]))
    summ = _t(dag, "cycles_output_summary", 0, outs)
    _t(dag, "cycles_plots", 0, [summ])
    return dag


def gen_montage(rng: random.Random) -> RawDag:
    dag: RawDag = {}
    n_img = rng.randint(10, 24)
    proj = [_t(dag, "mProject", i, []) for i in range(n_img)]
    n_diff = min(rng.randint(n_img, 2 * n_img), 48)
    diffs = []
    for i in range(n_diff):
        a, b = rng.sample(range(n_img), 2)
        diffs.append(_t(dag, "mDiffFit", i, [proj[a], proj[b]]))
    concat = _t(dag, "mConcatFit", 0, diffs)
    bg_model = _t(dag, "mBgModel", 0, [concat])
    bgs = [_t(dag, "mBackground", i, [proj[i], bg_model])
           for i in range(n_img)]
    imgtbl = _t(dag, "mImgtbl", 0, bgs)
    add = _t(dag, "mAdd", 0, [imgtbl])
    shrink = _t(dag, "mShrink", 0, [add])
    _t(dag, "mJPEG", 0, [shrink])
    return dag


def gen_nextflow(rng: random.Random) -> RawDag:
    dag: RawDag = {}
    n_samp = rng.randint(4, 9)
    merged = []
    for s in range(n_samp):
        qc = _t(dag, "fastqc", s, [])
        trim = _t(dag, "trimgalore", s, [qc])
        al = _t(dag, "star_align", s, [trim])
        dd = _t(dag, "markduplicates", s, [al])
        q2 = _t(dag, "qualimap", s, [dd])
        merged.append(q2)
    mq = _t(dag, "multiqc", 0, merged)
    _t(dag, "report", 0, [mq])
    return dag


def gen_rnaseq(rng: random.Random) -> RawDag:
    dag: RawDag = {}
    n = rng.randint(6, 12)
    counts = []
    for s in range(n):
        fq = _t(dag, "fastq_dump", s, [])
        al = _t(dag, "hisat2", s, [fq])
        counts.append(_t(dag, "htseq_count", s, [al]))
    m = _t(dag, "merge_counts", 0, counts)
    _t(dag, "deseq2", 0, [m])
    return dag


def gen_seismic(rng: random.Random) -> RawDag:
    dag: RawDag = {}
    n_st = rng.randint(16, 48)
    pre = [_t(dag, "sG1IterDecon", i, []) for i in range(n_st)]
    merge = _t(dag, "wrapper_siftSTFByMisfit", 0, pre)
    return dag


def gen_soykb(rng: random.Random) -> RawDag:
    dag: RawDag = {}
    n_samp = rng.randint(5, 10)
    gvcfs = []
    for s in range(n_samp):
        al = _t(dag, "alignment_to_reference", s, [])
        so = _t(dag, "sort_sam", s, [al])
        dd = _t(dag, "dedup", s, [so])
        ar = _t(dag, "add_replace", s, [dd])
        rt = _t(dag, "realign_target_creator", s, [ar])
        ir = _t(dag, "indel_realign", s, [rt])
        hc = _t(dag, "haplotype_caller", s, [ir])
        gvcfs.append(hc)
    cg = _t(dag, "combine_variants", 0, gvcfs)
    gt = _t(dag, "genotype_gvcfs", 0, [cg])
    sv = _t(dag, "select_variants_snp", 0, [gt])
    _t(dag, "filtering_snp", 0, [sv])
    return dag


def gen_srasearch(rng: random.Random) -> RawDag:
    dag: RawDag = {}
    n = rng.randint(16, 60)
    fetches = [_t(dag, "prefetch", i, []) for i in range(n)]
    searches = [_t(dag, "sra_search", i, [fetches[i]]) for i in range(n)]
    _t(dag, "merge_results", 0, searches)
    return dag


FAMILIES: dict[str, tuple[Callable[[random.Random], RawDag], int]] = {
    # family -> (generator, #instances in the paper's Table 8)
    "1000Genome": (gen_1000genome, 22),
    "BLAST": (gen_blast, 15),
    "BWA": (gen_bwa, 15),
    "Cycles": (gen_cycles, 19),
    "Montage": (gen_montage, 12),
    "Nextflow": (gen_nextflow, 9),
    "RNA-seq": (gen_rnaseq, 3),
    "SeismicCrossCorrelation": (gen_seismic, 11),
    "SoyKB": (gen_soykb, 10),
    "Srasearch": (gen_srasearch, 25),
}

# cache-dominant tracks use a fixed model alias to isolate locality and
# prefix-reuse behaviour (Appendix C.1 "Model assignment")
FIXED_MODEL_FAMILIES = {"Srasearch": "qwen-7b",
                        "SeismicCrossCorrelation": "deepseek-7b"}
