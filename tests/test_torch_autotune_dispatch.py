"""The port's dispatch-table tool (machineboss_tpu_torch/autotune_dispatch.py)
and the row it measured on the card.

derive() reproduces the thresholds the JAX script recorded for its `cpu`
and `tpu` rows from their own measurements; a CPU run on a small grid
writes the JAX schema; the committed dispatch_table_cuda.json holds one
`cuda` row, names its card and power limit, covers the JAX script's grid,
and its thresholds are derive() of its own lists.
"""

import json
import os

import pytest

from machineboss_tpu_torch import autotune_dispatch as ad

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TABLE = os.path.join(ROOT, "machineboss_tpu", "dispatch_table.json")


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_derive_reproduces_the_jax_rows(backend):
    row = _load(JAX_TABLE)["backends"][backend]
    assert ad.derive(row["one_d"], row["two_d"]) == row["derived"]


def test_cpu_run_writes_the_jax_schema(tmp_path, capsys):
    """A small grid on the CPU: the JAX keys per cell, the derived
    thresholds, merged beside a row already in the file; the committed
    tables are not touched."""
    here = os.path.join(ROOT, "machineboss_tpu_torch")
    committed = {name: open(os.path.join(here, name), "rb").read()
                 for name in ("dispatch_table.json",
                              "dispatch_table_cuda.json")}
    out = tmp_path / "table.json"
    out.write_text(json.dumps({"backends": {"tpu": {"kept": True}}}))
    doc = ad.main(device="cpu", out=out, grid=((4,), (16, 32)))
    lines = capsys.readouterr().out.splitlines()
    assert doc == _load(out)
    assert set(doc["backends"]) == {"cpu", "tpu"}
    assert doc["backends"]["tpu"] == {"kept": True}
    row = doc["backends"]["cpu"]
    assert row["backend"] == "cpu" and row["nvidia_smi"] is None
    assert [(r["S"], r["L"]) for r in row["one_d"]] == [(4, 16), (4, 32)]
    assert [(r["S"], r["L"]) for r in row["two_d"]] == [(4, 16), (4, 32)]
    for r in row["one_d"]:
        assert set(r) == {"S", "L", "scan_s", "assoc_s", "winner"}
        assert r["winner"] == ("assoc" if r["assoc_s"] < r["scan_s"]
                               else "scan")
    for r in row["two_d"]:
        assert set(r) == {"S", "L", "rows_s", "wavefront_s", "winner"}
        assert r["winner"] == ("wavefront" if r["wavefront_s"] < r["rows_s"]
                               else "rows")
    assert row["derived"] == ad.derive(row["one_d"], row["two_d"])
    assert len(lines) == 5 and lines[-1].startswith("wrote ")
    for name, data in committed.items():
        assert open(os.path.join(here, name), "rb").read() == data
    assert not os.path.exists(ad.table_path("cpu"))


def test_committed_cuda_row_was_measured_on_the_card():
    doc = _load(ad.table_path("cuda"))
    assert list(doc["backends"]) == ["cuda"]
    row = doc["backends"]["cuda"]
    assert row["backend"] == "cuda"
    name, limit = (x.strip() for x in row["nvidia_smi"].split(","))
    assert "H100" in name and name in row["device_name"]
    assert limit.endswith(" W") and float(limit[:-2]) > 0
    assert row["torch_version"] and row["cuda_version"]
    (s1, l1), (s2, l2) = ad.ONE_D_GRID, ad.TWO_D_GRID
    assert [(r["S"], r["L"]) for r in row["one_d"]] \
        == [(s, n) for s in s1 for n in l1]
    assert [(r["S"], r["L"]) for r in row["two_d"]] \
        == [(s, n) for s in s2 for n in l2]
    assert row["derived"] == ad.derive(row["one_d"], row["two_d"])
