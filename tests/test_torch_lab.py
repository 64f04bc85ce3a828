"""The port's kernel tools (ed25519_consensus_tpu_torch/tools/kernel_lab.py
and microbench.py) on the CPU, where every wrapper runs its plain PyTorch
version: the variant sweep and the stage profile run end to end at a small
shape (one batch of 128 lanes), every sweep form passes its parity gate
against the exact host MSM, the profile carries the JAX tool's keys, and
both tools skip without a card.  Also the bookkeeping the card run relies
on: every compiled instantiation has its C entry in its source, and the
compiler's register report parses.  The timings these runs print are host
times of the plain versions and say nothing about the card."""

import json
import re

import pytest
import torch

from ed25519_consensus_tpu_torch.ops import _cuda, msm
from ed25519_consensus_tpu_torch.tools import (kernel_lab, microbench,
                                               ptxas_report)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; one torch thread per
    test worker keeps the workers out of each other's way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sweep_on_the_plain_versions():
    sweep = kernel_lab.exp_sweep(1, 128, device="cpu", reps=1,
                                 emit=False)["kernel_sweep"]
    assert sweep["device"] == "cpu" and sweep["shape"] == [1, 128]
    assert list(sweep["results"]) == [f[0] for f in kernel_lab.SWEEP]
    for name, row in sweep["results"].items():
        assert row.get("parity") == "ok", (name, row)
        assert row["ms_per_call"] > 0 and row["terms_per_sec"] > 0
    assert sweep["selected"] in sweep["results"]
    assert sweep["pin"] == sweep["results"][sweep["selected"]]["pin"]
    json.dumps(sweep)


def test_sweep_forms_name_built_instantiations():
    """Every sweep form resolves to a compiled instantiation, and together
    they reach every window-sum instantiation but K2s, which the stage
    profile reaches."""
    reached = set()
    for name, entry, wb, kw, _pin in kernel_lab.SWEEP:
        base, suffix, _, W = kernel_lab.sweep_form(entry, wb, kw)
        assert base in _cuda.INSTANTIATIONS, name
        assert suffix == ("" if W == msm.nwindows(wb) else f"-w{W}")
        reached.add(base)
    window = {b for b in _cuda.INSTANTIATIONS
              if b.startswith("window_")}
    assert window - reached == {"window_select_only"}


def test_profile_ledger_on_the_plain_versions(capsys):
    ledger = microbench.profile_ledger(1, 128, reps=1, device="cpu")
    assert {"total_ms", "kernel_ms", "table_build_ms", "select_ms",
            "fold_in_kernel_ms", "xla_fold_ms", "terms_per_sec_full",
            "terms_per_sec_tables_resident", "shape", "win_chunk",
            "reps"} <= set(ledger)
    assert ledger["win_chunk"] == 33 and ledger["device"] == "cpu"
    # each bucket names its arithmetic: no bucket subtracts a form of one
    # from a form of the other
    assert ledger["arithmetic"]["table_build_ms"] == "u32"
    assert ledger["arithmetic"]["fold_in_kernel_ms"] == "l20"
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if "device_program_profile" in ln]
    assert json.loads(line[-1])["device_program_profile"]["shape"] == \
        [1, 128]


def test_probes_on_the_plain_versions():
    row = microbench.probe_chain("madd", tile=(8, 128), n_steps=(4, 8),
                                 device="cpu", reps=1)
    assert row["op"] == "madd" and len(row["ms"]) == 2
    row = microbench.probe_fmul(tile=(8, 128), n_steps=(1, 2),
                                device="cpu", reps=1)
    assert "us_per_fmul" in row


@pytest.mark.parametrize("tool,argv", [
    (kernel_lab, ["--exp", "sweep"]),
    (kernel_lab, ["--exp", "ab"]),
    (microbench, []),
    (microbench, ["--profile-ledger", "8", "12288"]),
    (ptxas_report, []),
])
def test_tools_skip_without_a_card(tool, argv, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_cuda, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    assert tool.main(argv) == 0
    assert "SKIPPED" in capsys.readouterr().out


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """No fallback: without a card the lab's device entry points raise
    unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = torch.zeros((1, 33, 64), dtype=torch.int8)
    e = torch.zeros((1, 4, 20, 64), dtype=torch.int16)
    t = torch.zeros((1, 9, 4, 20, 64), dtype=torch.int16)
    for call in (lambda: msm.window_sums_many(d, e),
                 lambda: msm.window_sums_many_tables_full(d, t),
                 lambda: msm.window_select_only(d, t),
                 lambda: msm.build_multiples_tables(e, window_bits=5),
                 lambda: kernel_lab.exp_sweep(1, 64, reps=1, emit=False),
                 lambda: microbench.probe_chain("add")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_every_instantiation_has_its_entry_in_its_source():
    """The C entry `<base with - as _>_launch` of every registered
    instantiation is defined in its source (and in its any-W source, where
    it has one), by an instantiation macro or written out."""
    held = [(b, src) for b, (src, _) in _cuda.INSTANTIATIONS.items()]
    for base, src in held + list(_cuda.W_SOURCES.items()):
        text = (_cuda.CSRC / src).read_text(encoding="utf-8")
        name = base.replace("-", "_")
        assert re.search(rf"\b[A-Z_0-9]+\({name}[,)]|\b{name}_launch\(",
                         text), (base, src)
    assert _cuda.entry_of("window_sums-r32") == "window_sums_r32_launch"
    assert _cuda.base_of("window_sums_tables-r32-w9") == \
        "window_sums_tables-r32"


def test_block_forms_match_the_sources_and_the_paths():
    """Each window-sum instantiation's FORMS argument in its source is the
    one _cuda.BLOCK_FORMS gives ("both" when unlisted), and it is what the
    paths launch: every window in one block ("all"), fewer ("w"), or both.
    So no kernel is built that no path launches.  The default K2 and K2t
    (WS_K2_U32 / WS_K2T_U32, which take no FORMS) are "all" only; the
    windows-per-block knob reaches the 20-limb kernels' any-W form."""
    held = {}
    for src in _cuda.sources():
        text = (_cuda.CSRC / src).read_text(encoding="utf-8")
        for m in re.finditer(
                r"^WS_K2T?(?:\((\w+), (ALL|W|BOTH)[,)]|_U32\((\w+)\))",
                text, re.M):
            name, forms = (m.group(1), m.group(2)) if m.group(1) else (
                m.group(3), "ALL")
            held.setdefault(name, set()).update(
                {"ALL": {"all"}, "W": {"w"}, "BOTH": {"all", "w"}}[forms])
            if forms == "W" and src in _cuda.W_SOURCES.values():
                assert {b.replace("-", "_"): f for b, f in
                        _cuda.W_SOURCES.items()}[name] == src
    seen = {n: "both" if f == {"all", "w"} else f.pop()
            for n, f in held.items()}
    window = {b for b in _cuda.INSTANTIATIONS if b.startswith("window_")}
    assert set(seen) == {b.replace("-", "_") for b in window}
    assert _cuda.kernel("window_sums-l20", "-w11").source == \
        "window_sums_w.cu"
    assert _cuda.KERNELS["window_sums"].source == "window_sums.cu"
    # the verdict paths and their knobs, the stage profile, then the sweep
    used = {"window_sums": {"all"}, "window_sums_tables": {"all"},
            "window_sums-l20": {"w"}, "window_sums_tables-l20": {"all", "w"},
            "window_sums-hybrid": {"all"}, "window_select_only": {"all"}}
    for name, entry, wb, kw, _pin in kernel_lab.SWEEP:
        base, suffix, _, _ = kernel_lab.sweep_form(entry, wb, kw)
        used.setdefault(base, set()).add("w" if suffix else "all")
    for b in window:
        form = _cuda.BLOCK_FORMS.get(b, "both")
        assert seen[b.replace("-", "_")] == form, b
        assert form == ("both" if used[b] == {"all", "w"}
                        else used[b].pop()), b


@pytest.mark.parametrize("kind,kw,want", [
    ("window_sums", {"tbl_dtype": "int32", "win_chunk": 11}, None),
    ("window_select_only", {"win_chunk": 3}, None),
    ("window_sums", {"fold_dtype": "int16"},
     ("window_sums-i16fold", "", 64, 33, "window_sums_i16fold_w_kernel")),
    ("window_sums", {"win_chunk": 11},
     ("window_sums-l20", "-w11", 64, 11, "window_sums_l20_w_kernel")),
    ("window_sums", {}, ("window_sums", "", 64, 33, "window_sums_kernel")),
], ids=["i32tbl-w11", "select-only-w3", "i16fold-all", "default-w11",
        "default"])
def test_block_forms_raise_where_not_built(kind, kw, want):
    """A windows-per-block form an instantiation does not hold raises
    ValueError (nothing falls back to another form); a form it holds
    resolves to the kernel ptxas names: a "w"-only instantiation runs
    every window in one block through its any-W kernel."""
    if want is None:
        with pytest.raises(ValueError, match="windows a block"):
            msm.kernel_form(kind, **kw)
        return
    base, suffix, chunk, W = msm.kernel_form(kind, **kw)
    assert (base, suffix, chunk, W) == want[:4]
    assert _cuda.kernel_symbol(base, suffix) == want[4]


@pytest.mark.parametrize("body", ["rolled", "hybrid"])
def test_load_all_builds_only_the_verdict_set(monkeypatch, body):
    """A verdict path's first call builds and loads the instantiations it
    launches (and the hybrid body or the any-W kernels when a knob selects
    them), not the lab's forms or the probes; a lab source builds alone at
    its first launch."""
    built, loaded = [], []
    monkeypatch.setattr(_cuda, "build_all",
                        lambda srcs=None: built.append(srcs) or {})
    monkeypatch.setattr(_cuda.Kernel, "function",
                        lambda self: loaded.append(self.name))
    monkeypatch.setenv("ED25519_TPU_PALLAS_BODY", body)
    monkeypatch.delenv("ED25519_TPU_WIN_CHUNK", raising=False)
    _cuda.load_all()
    extra = ["window_sums-hybrid"] if body == "hybrid" else []
    assert loaded == list(_cuda.VERDICT) + extra
    assert built == [sorted(set(_cuda.VERDICT_SOURCES) | {
        _cuda.INSTANTIATIONS[b][0] for b in extra})]
    assert not {"window_sums_lab.cu", "window_sums_r32.cu", "probes.cu",
                "window_sums_w.cu"} & set(built[0])
    monkeypatch.setenv("ED25519_TPU_WIN_CHUNK", "11")
    _cuda.load_all()
    assert set(built[1]) == set(built[0]) | {"window_sums_w.cu"}
    assert _cuda.build_group("probes.cu") == ["probes.cu"]
    assert _cuda.build_group("window_sums.cu") == \
        list(_cuda.VERDICT_SOURCES)


def test_forms_count_their_launches_apart():
    """A windows-per-block form has its instantiation's C entry name (the
    20-limb default's any-W kernel in a source of its own) and keeps a launch
    count of its own."""
    k = _cuda.kernel("window_sums-l20", "-w11")
    assert k is _cuda.kernel("window_sums-l20", "-w11")
    assert k is not _cuda.KERNELS["window_sums-l20"]
    assert k.entry == _cuda.KERNELS["window_sums-l20"].entry == \
        "window_sums_l20_launch"
    assert k.source == "window_sums_w.cu"
    assert _cuda.kernel("window_sums-r32", "-w9").source == \
        "window_sums_r32.cu"
    assert _cuda.launch_counts()["window_sums-l20-w11"] == k.launches


def test_ptxas_report_parses():
    log = """ptxas info    : 0 bytes gmem, 240 bytes cmem[3]
ptxas info    : Compiling entry function 'window_sums_r32_kernel' for 'sm_90a'
ptxas info    : Function properties for window_sums_r32_kernel
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Function properties for _Z6fe_mul2feS_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function 'probe_fmul_kernel' for 'sm_90a'
ptxas info    : Function properties for probe_fmul_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 376 bytes cmem[0]
"""
    assert _cuda.ptxas_usage(log) == {
        "window_sums_r32_kernel": {"registers": 255, "spill_stores": 4,
                                   "spill_loads": 12},
        "probe_fmul_kernel": {"registers": 96, "spill_stores": 0,
                              "spill_loads": 0}}


def test_k4_runs_k2s_table_phase():
    """K4 (build_tables.cu) builds its tables with K2's own table phase
    (window_sums_u32.cuh build_table), not a second copy of the tree: one
    block is K2's chunk of 64 lanes and its 128 table threads over the u32
    table, so the report prices 128 threads and 65,536 B a block, which
    holds 3 blocks (12 warps) an SM at K2's 128 registers, and the launch
    bounds swept stop there."""
    src = (_cuda.CSRC / "build_tables.cu").read_text(encoding="utf-8")
    k4 = src[:src.index("// -- the 20-limb kernels")]
    assert '#include "window_sums_u32.cuh"' in k4
    assert "ws8::build_table(" in k4 and "ge8_add" not in k4.split(
        "#include", 1)[1]
    header = (_cuda.CSRC / "window_sums_u32.cuh").read_text(encoding="utf-8")
    assert "build_table(tbl, points, b, lane0, N);" in header
    assert ptxas_report.FE8_BLOCKS["build_tables_kernel"] == (
        2 * msm.CHUNK, msm.U32_TABLE_BYTES) == (128, 65_536)
    occ = ptxas_report.occupancy(128, 128, msm.U32_TABLE_BYTES)
    assert occ == {"blocks": 3, "warps": 12, "limited_by": "shared memory"}
    assert max(ptxas_report.K4_MIN_BLOCKS) == occ["blocks"]


def test_occupancy_and_sass_parsing(monkeypatch, tmp_path):
    """The resident warps a register count implies for the default K2 /
    K2t block (160 threads, 67,648 B), and the SASS parser: the n-th CALL
    of the self-test kernel targets the n-th operation's body, counted to
    its RET."""
    assert ptxas_report.occupancy(128) == {
        "blocks": 3, "warps": 15, "limited_by": "registers"}
    assert ptxas_report.occupancy(96)["limited_by"] == "shared memory"
    assert ptxas_report.occupancy(168)["warps"] == 10
    sass = tmp_path / "k.sass"
    sass.write_text("""
\t\tFunction : probe_fe8_kernel
        /*0000*/                   CALL.REL.NOINC 0x40 ;
        /*0010*/                   CALL.REL.NOINC 0x80 ;
        /*0020*/                   EXIT ;
        /*0030*/                   BRA 0x30;
        /*0040*/                   IMAD R1, R2, R3, RZ ;
        /*0050*/                   IADD3.X R4, P0, R5, R6, RZ, P0, !PT ;
        /*0060*/                   RET.REL.NODEC R20 0x0 ;
        /*0070*/                   NOP;
        /*0080*/              @P0   IMAD.HI.U32 R1, R2, R3, RZ ;
        /*0090*/                   RET.REL.NODEC R20 0x0 ;
\t\tFunction : other_kernel
        /*0000*/                   CALL.REL.NOINC 0x40 ;
""")
    tool = tmp_path / "cuobjdump"
    tool.write_text('#!/bin/sh\ncat "$2"\n')
    tool.chmod(0o755)
    monkeypatch.setattr(ptxas_report, "cuobjdump_path", lambda: str(tool))
    assert ptxas_report.sass_counts(sass, calls=("a", "b")) == {
        "a": {"instructions": 2, "imad": 1},
        "b": {"instructions": 1, "imad": 1}}
