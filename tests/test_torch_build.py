"""`build.library_path` names a library by a hash of its source and of every
file under `csrc/` the source includes, so a changed header never loads a
stale library.  Needs no nvcc and no card."""

from deflicker_torch.ops.cuda import build


def _tree(root):
    (root / "sub").mkdir()
    (root / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\nint f();\n')
    (root / "a.cuh").write_text('#include "sub/b.cuh"\n#include "missing.cuh"\n')
    # an include cycle back to a.cuh, relative to the including file
    (root / "sub" / "b.cuh").write_text('#include "../a.cuh"\n// v1\n')


def test_sources_follow_includes_once(tmp_path, monkeypatch):
    _tree(tmp_path)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]


def test_library_path_changes_with_an_included_header(tmp_path, monkeypatch):
    _tree(tmp_path)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert first == build.library_path("k") and first.name.startswith("libk-")
    (tmp_path / "sub" / "b.cuh").write_text('#include "../a.cuh"\n// v2\n')
    second = build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint g();\n')
    assert build.library_path("k") not in (first, second)


def test_shipped_sources_and_their_headers():
    assert [p.name for p in build.sources("imlp_chain")] == ["imlp_chain.cu",
                                                              "hopper.cuh"]
    assert [p.name for p in build.sources("corr_lookup")] == ["corr_lookup.cu"]
