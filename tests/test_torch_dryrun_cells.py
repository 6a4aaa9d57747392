"""`repro_torch.launch.dryrun.run_cell` on one arch of each family at its
published widths, cut to 2 layers (the rest of the dry run's tests are in
test_torch_dryrun.py): every record's fields hold together, and a cell
the JAX package skips is skipped for its reason."""
import dataclasses

import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import cell_applicable as jcell_applicable
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun, mesh

SKIPPED = ("qwen3-14b", "long_500k")      # a full-attention arch


CELLS = [("qwen2-0.5b", "train_4k"), ("mixtral-8x22b", "train_4k"),
         ("mamba2-370m", "train_4k"), ("zamba2-7b", "train_4k"),
         ("seamless-m4t-medium", "train_4k"),
         ("llama-3.2-vision-90b", "train_4k"), ("qwen2-0.5b", "prefill_32k"),
         ("qwen2-0.5b", "decode_32k"), SKIPPED]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell(arch, shape):
    """At the published widths and 2 layers, one arch of each family on
    train_4k, a prefill and a decode cell give `ok` records whose fields
    hold together; long_500k on a full-attention arch gives `skipped` with
    the JAX package's reason."""
    rec = dryrun.run_cell(arch, shape, cfg_overrides={"n_layers": 2})
    assert (rec["arch"], rec["shape"], rec["chips"]) == (arch, shape, 1)
    if (arch, shape) == SKIPPED:
        assert rec["status"] == "skipped"
        assert rec["reason"] == jcell_applicable(JARCHS[arch], shape)[1]
        return
    assert rec["status"] == "ok", rec.get("traceback")
    cell = SHAPES[shape]
    assert rec["n_micro"] == (cell.global_batch if cell.kind == "train"
                              else 1)
    assert rec["opt_bits"] == 32
    m, p, r = rec["memory"], rec["parsed"], rec["roofline"]
    assert m["total_per_device"] == m["argument_bytes"] + m["temp_bytes"]
    assert m["fits_80GB"] == (m["total_per_device"] < 80e9)
    assert m["argument_bytes"] > 0 and m["output_bytes"] > 0
    assert p["flops"] > 0 and p["hbm_bytes"] > 0
    assert p["coll_bytes_total"] == 0 and p["coll_counts"] == {}
    assert r["compute_s"] == p["flops"] / mesh.PEAK_FLOPS_BF16
    assert r["memory_s"] == p["hbm_bytes"] / mesh.HBM_BW
    secs = {k: r[k] for k in ("compute_s", "memory_s", "collective_s")}
    assert r["bound_s"] == max(secs.values())
    assert r["dominant"] == max(secs, key=secs.get)
    assert 0 < r["roofline_fraction"] <= 1.0
    assert r["model_flops_global"] == dryrun.model_flops(
        dataclasses.replace(ARCHS[arch], n_layers=2), shape)
