"""The port's C embedding bindings (parsec_tpu_torch/bindings/): a C
program built against libparsec_tpu_c initialises the runtime and runs
a 3-task saxpy chain through the DTD API from C.  Mirrors the JAX
package's ``tests/test_info_help_bindings.py`` C test; the library is
built into a temporary directory (``build(out_dir=...)``), and the
program runs with ``PARSEC_MCA_device_cuda_platform=cpu`` (``ptc_init``
puts the device module on cuda:0 otherwise, and raises without a
card)."""
import os
import subprocess

import pytest

from parsec_tpu_torch.bindings import build as bbuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

C_DRIVER = r"""
#include <stdio.h>
#include "parsec_tpu_c.h"

static void saxpy_body(float **tiles, int ntiles, void *user) {
    float a = *(float *)user;
    float *y = tiles[0];
    const float *x = tiles[1];
    for (int i = 0; i < 16; i++) y[i] += a * x[i];
}

int main(void) {
    ptc_context *ctx = ptc_init(2);
    if (!ctx) { fprintf(stderr, "init: %s\n", ptc_last_error()); return 1; }
    printf("version=%s\n", ptc_version());
    printf("devices=%s\n", ptc_device_names(ctx));

    float ybuf[16], xbuf[16], a = 3.0f;
    for (int i = 0; i < 16; i++) { ybuf[i] = 1.0f; xbuf[i] = (float)i; }

    ptc_taskpool *tp = ptc_dtd_taskpool_new(ctx);
    if (!tp) { fprintf(stderr, "tp: %s\n", ptc_last_error()); return 1; }
    ptc_tile *y = ptc_tile_of_dense(tp, ybuf, 4, 4);
    ptc_tile *x = ptc_tile_of_dense(tp, xbuf, 4, 4);
    ptc_tile *tiles[2] = { y, x };
    int modes[2] = { PTC_INOUT, PTC_INPUT };
    for (int k = 0; k < 3; k++) {
        if (ptc_insert_task(tp, saxpy_body, &a, 2, tiles, modes) != 0) {
            fprintf(stderr, "insert: %s\n", ptc_last_error());
            return 1;
        }
    }
    if (ptc_data_flush_all(tp) != 0) return 1;
    if (ptc_taskpool_wait(tp) != 0) {
        fprintf(stderr, "wait: %s\n", ptc_last_error());
        return 1;
    }
    /* y = 1 + 3*3*i */
    for (int i = 0; i < 16; i++) {
        float want = 1.0f + 9.0f * (float)i;
        if (ybuf[i] != want) {
            fprintf(stderr, "y[%d] = %f != %f\n", i, ybuf[i], want);
            return 2;
        }
    }
    ptc_tile_free(y);
    ptc_tile_free(x);
    ptc_taskpool_free(tp);
    ptc_fini(ctx);
    printf("C-BINDING-OK\n");
    return 0;
}
"""


def _compile(tmp_path):
    so = bbuild.build(out_dir=tmp_path / "lib")
    assert so.startswith(str(tmp_path))          # never the package dir
    src = tmp_path / "driver.c"
    src.write_text(C_DRIVER)
    exe = str(tmp_path / "driver")
    libdir = os.path.dirname(so)
    subprocess.run(
        [bbuild.compiler(), "-O1", str(src), "-o", exe,
         f"-I{bbuild.include_dir()}", so, f"-Wl,-rpath,{libdir}"]
        + bbuild.python_link_flags(), check=True)
    return exe


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PARSEC_MCA_")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_c_embedding_end_to_end(tmp_path):
    """Compile a C program against libparsec_tpu_c and run a 3-task saxpy
    chain through the runtime from C (device module over host tensors)."""
    exe = _compile(tmp_path)
    r = subprocess.run([exe], capture_output=True, text=True, timeout=180,
                       env=_env(PARSEC_MCA_device_cuda_platform="cpu"))
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "C-BINDING-OK" in r.stdout
    assert "version=" in r.stdout
    assert "devices=cpu,cpu" in r.stdout
    # nothing was built under the package directory
    pkg = os.path.join(ROOT, "parsec_tpu_torch", "bindings")
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]


def test_c_init_without_card_fails_loudly(tmp_path):
    """ptc_init on a machine without a card returns NULL with the
    runtime's error (no silent CPU fallback)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: ptc_init succeeds on it")
    exe = _compile(tmp_path)
    r = subprocess.run([exe], capture_output=True, text=True, timeout=180,
                       env=_env())
    assert r.returncode == 1
    assert "no CUDA device" in r.stderr


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler error raises RuntimeError with its output."""
    monkeypatch.setattr(bbuild, "compiler", lambda: "false")
    with pytest.raises(RuntimeError, match="did not build"):
        bbuild.build(out_dir=tmp_path / "lib", force=True)
