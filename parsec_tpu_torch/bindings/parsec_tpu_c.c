/* C embedding shim for the parsec_tpu_torch runtime (see parsec_tpu_c.h).
 *
 * Thin CPython-API layer: owns the embedded interpreter, holds opaque
 * PyObject handles, and forwards every call to
 * parsec_tpu_torch.bindings.chelper (the reference's Fortran bindings are the
 * same shape: a thin marshalling layer over the core runtime API,
 * parsec/fortran/parsecf.F90).
 */
#include <Python.h>
#include <stdio.h>
#include <string.h>

#include "parsec_tpu_c.h"

struct ptc_context { PyObject *ctx; int owns_interp; };
struct ptc_taskpool { PyObject *tp; };
struct ptc_tile { PyObject *tile; };

static char g_err[1024];
static PyObject *g_helper = NULL;

static void set_err_from_python(void) {
    PyObject *type = NULL, *value = NULL, *tb = NULL;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    g_err[0] = '\0';
    if (value != NULL) {
        PyObject *s = PyObject_Str(value);
        if (s != NULL) {
            const char *c = PyUnicode_AsUTF8(s);
            if (c != NULL) { strncpy(g_err, c, sizeof(g_err) - 1); }
            Py_DECREF(s);
        }
    }
    if (g_err[0] == '\0') strcpy(g_err, "unknown python error");
    Py_XDECREF(type); Py_XDECREF(value); Py_XDECREF(tb);
}

static PyObject *helper(void) {
    if (g_helper == NULL) {
        g_helper = PyImport_ImportModule("parsec_tpu_torch.bindings.chelper");
        if (g_helper == NULL) set_err_from_python();
    }
    return g_helper;
}

const char *ptc_last_error(void) { return g_err; }

ptc_context *ptc_init(int nb_cores) {
    g_err[0] = '\0';
    int owns = 0;
    if (!Py_IsInitialized()) {
        Py_Initialize();
        /* drop the GIL acquired by Py_Initialize so runtime worker
         * threads can run task bodies while this thread is in C code;
         * every ptc_* entry point re-acquires via PyGILState_Ensure */
        (void)PyEval_SaveThread();
        owns = 1;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    ptc_context *out = NULL;
    PyObject *mod = helper();
    if (mod != NULL) {
        PyObject *ctx = PyObject_CallMethod(mod, "init", "i", nb_cores);
        if (ctx == NULL) { set_err_from_python(); }
        else {
            out = (ptc_context *)malloc(sizeof(*out));
            out->ctx = ctx;
            out->owns_interp = owns;
        }
    }
    PyGILState_Release(st);
    return out;
}

void ptc_fini(ptc_context *ctx) {
    g_err[0] = '\0';
    if (ctx == NULL) return;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(helper(), "fini", "O", ctx->ctx);
    if (r == NULL) { set_err_from_python(); PyErr_Clear(); }
    Py_XDECREF(r);
    Py_DECREF(ctx->ctx);
    PyGILState_Release(st);
    /* the embedded interpreter stays up: worker threads may still be
     * parked in it, and a later ptc_init can reuse it */
    free(ctx);
}

ptc_taskpool *ptc_dtd_taskpool_new(ptc_context *ctx) {
    g_err[0] = '\0';
    if (ctx == NULL) return NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    ptc_taskpool *out = NULL;
    PyObject *tp = PyObject_CallMethod(helper(), "taskpool_new", "O",
                                       ctx->ctx);
    if (tp == NULL) { set_err_from_python(); }
    else {
        out = (ptc_taskpool *)malloc(sizeof(*out));
        out->tp = tp;
    }
    PyGILState_Release(st);
    return out;
}

ptc_tile *ptc_tile_of_dense(ptc_taskpool *tp, float *data,
                            long rows, long cols) {
    g_err[0] = '\0';
    if (tp == NULL || data == NULL) return NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    ptc_tile *out = NULL;
    PyObject *tile = PyObject_CallMethod(helper(), "tile_of_dense", "OKll",
                                         tp->tp, (unsigned long long)(size_t)data,
                                         rows, cols);
    if (tile == NULL) { set_err_from_python(); }
    else {
        out = (ptc_tile *)malloc(sizeof(*out));
        out->tile = tile;
    }
    PyGILState_Release(st);
    return out;
}

int ptc_insert_task(ptc_taskpool *tp, ptc_body_fn fn, void *user,
                    int ntiles, ptc_tile **tiles, const int *modes) {
    g_err[0] = '\0';
    if (tp == NULL || fn == NULL) return -1;
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    PyObject *tlist = PyList_New(ntiles);
    PyObject *mlist = PyList_New(ntiles);
    if (tlist != NULL && mlist != NULL) {
        for (int i = 0; i < ntiles; i++) {
            Py_INCREF(tiles[i]->tile);
            PyList_SET_ITEM(tlist, i, tiles[i]->tile);
            PyList_SET_ITEM(mlist, i, PyLong_FromLong(modes[i]));
        }
        PyObject *r = PyObject_CallMethod(
            helper(), "insert_task", "OKKOO", tp->tp,
            (unsigned long long)(size_t)fn,
            (unsigned long long)(size_t)user, tlist, mlist);
        if (r == NULL) { set_err_from_python(); }
        else { rc = 0; Py_DECREF(r); }
    }
    Py_XDECREF(tlist);
    Py_XDECREF(mlist);
    PyGILState_Release(st);
    return rc;
}

static int call_int_method(ptc_taskpool *tp, const char *name) {
    g_err[0] = '\0';
    if (tp == NULL) return -1;
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    PyObject *r = PyObject_CallMethod(helper(), name, "O", tp->tp);
    if (r == NULL) { set_err_from_python(); }
    else { rc = (int)PyLong_AsLong(r); Py_DECREF(r); }
    PyGILState_Release(st);
    return rc;
}

int ptc_data_flush_all(ptc_taskpool *tp) {
    return call_int_method(tp, "data_flush_all");
}

int ptc_taskpool_wait(ptc_taskpool *tp) {
    return call_int_method(tp, "taskpool_wait");
}

void ptc_taskpool_free(ptc_taskpool *tp) {
    if (tp == NULL) return;
    PyGILState_STATE st = PyGILState_Ensure();
    Py_DECREF(tp->tp);
    PyGILState_Release(st);
    free(tp);
}

void ptc_tile_free(ptc_tile *tile) {
    if (tile == NULL) return;
    PyGILState_STATE st = PyGILState_Ensure();
    Py_DECREF(tile->tile);
    PyGILState_Release(st);
    free(tile);
}

const char *ptc_version(void) {
    static char buf[64] = "";
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(helper(), "version", NULL);
    if (r != NULL) {
        const char *c = PyUnicode_AsUTF8(r);
        if (c != NULL) strncpy(buf, c, sizeof(buf) - 1);
        Py_DECREF(r);
    } else { set_err_from_python(); PyErr_Clear(); }
    PyGILState_Release(st);
    return buf;
}

const char *ptc_device_names(ptc_context *ctx) {
    static char buf[256] = "";
    g_err[0] = '\0';
    if (ctx == NULL) return NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    const char *out = NULL;
    PyObject *r = PyObject_CallMethod(helper(), "device_names", "O",
                                      ctx->ctx);
    if (r != NULL) {
        const char *c = PyUnicode_AsUTF8(r);
        if (c != NULL) {
            strncpy(buf, c, sizeof(buf) - 1);
            out = buf;
        } else { set_err_from_python(); }
        Py_DECREF(r);
    } else { set_err_from_python(); }
    PyGILState_Release(st);
    return out;
}
