/* A C program that drives cylon_tpu_torch through the table_api string-id
 * registry, as the reference's Java/JNI layer consumes its C++ registry
 * (reference: java/src/main/native/src/Table.cpp:26-67 — JNI functions
 * resolve string table ids against table_api.hpp and invoke the
 * operators).
 *
 * The engine is Python-resident (PyTorch and the port's CUDA kernels), so
 * the C side embeds the interpreter and talks only in C types and string
 * ids: no Python object crosses the call sites below, which is the
 * contract a JNI/FFI layer needs. It reads two CSVs, joins them (inner,
 * on column 0, the AUTO algorithm), counts the rows and writes the
 * result:
 *
 *   cylon_cbind LEFT.csv RIGHT.csv OUT.csv [DEVICE]
 *
 * DEVICE is "cuda" (the default: the join runs on the card) or "cpu".
 * It prints "CBIND OK rows=<n> out=<path>", then the kernel launch
 * counts of the run as "LAUNCHES <json>". Built and run by
 * cylon_tpu_torch/cbind.py (build(), run()).
 */
#include <Python.h>
#include <stdio.h>
#include <string.h>

static int check(PyObject *o, const char *what) {
    if (o != NULL) { Py_DECREF(o); return 0; }
    fprintf(stderr, "FAILED: %s\n", what);
    PyErr_Print();
    return 1;
}

/* C-ABI style wrappers over the registry (the JNI-analog surface) */
static PyObject *g_api = NULL;
static PyObject *g_ctx = NULL;

static int ct_read_csv(const char *path, const char *table_id) {
    PyObject *r = PyObject_CallMethod(g_api, "read_csv", "Oss",
                                      g_ctx, path, table_id);
    return check(r, "read_csv");
}

/* an inner join with the AUTO algorithm: the card picks the route for
 * the key's width (the sort stream for a 4-byte key; the hash stream for
 * the int64 keys the CSV reader gives integers), both on K3 and K4 */
static int ct_join(const char *left_id, const char *right_id,
                   int left_col, int right_col, const char *out_id) {
    PyObject *join_mod = PyImport_ImportModule("cylon_tpu_torch.ops.join");
    if (!join_mod) { PyErr_Print(); return 1; }
    PyObject *cfg_cls = PyObject_GetAttrString(join_mod, "JoinConfig");
    PyObject *alg_cls = PyObject_GetAttrString(join_mod, "JoinAlgorithm");
    PyObject *alg = alg_cls ? PyObject_GetAttrString(alg_cls, "AUTO")
                            : NULL;
    PyObject *cfg = cfg_cls && alg
        ? PyObject_CallMethod(cfg_cls, "InnerJoin", "iiO",
                              left_col, right_col, alg)
        : NULL;
    int rc = 1;
    if (cfg) {
        PyObject *r = PyObject_CallMethod(g_api, "join_tables", "ssOs",
                                          left_id, right_id, cfg, out_id);
        rc = check(r, "join_tables");
    } else {
        PyErr_Print();
    }
    Py_XDECREF(cfg);
    Py_XDECREF(alg);
    Py_XDECREF(alg_cls);
    Py_XDECREF(cfg_cls);
    Py_DECREF(join_mod);
    return rc;
}

static long ct_row_count(const char *table_id) {
    PyObject *r = PyObject_CallMethod(g_api, "row_count", "s", table_id);
    if (!r) { PyErr_Print(); return -1; }
    long n = PyLong_AsLong(r);
    Py_DECREF(r);
    return n;
}

static int ct_write_csv(const char *table_id, const char *path) {
    PyObject *r = PyObject_CallMethod(g_api, "write_csv", "ss",
                                      table_id, path);
    return check(r, "write_csv");
}

int main(int argc, char **argv) {
    if (argc < 4) {
        fprintf(stderr, "usage: %s LEFT.csv RIGHT.csv OUT.csv [DEVICE]\n",
                argv[0]);
        return 1;
    }
    const char *csv1 = argv[1];
    const char *csv2 = argv[2];
    const char *out = argv[3];
    const char *device = argc > 4 ? argv[4] : "cuda";

    Py_Initialize();
    g_api = PyImport_ImportModule("cylon_tpu_torch.table_api");
    if (!g_api) { PyErr_Print(); return 2; }
    PyObject *ct = PyImport_ImportModule("cylon_tpu_torch");
    if (!ct) { PyErr_Print(); return 2; }
    PyObject *ctx_cls = PyObject_GetAttrString(ct, "CylonContext");
    g_ctx = ctx_cls ? PyObject_CallMethod(ctx_cls, "Init", "s", device)
                    : NULL;
    if (!g_ctx) { PyErr_Print(); return 2; }

    if (ct_read_csv(csv1, "c-left")) return 3;
    if (ct_read_csv(csv2, "c-right")) return 3;
    if (ct_join("c-left", "c-right", 0, 0, "c-out")) return 3;
    long rows = ct_row_count("c-out");
    if (rows < 0) return 3;
    if (ct_write_csv("c-out", out)) return 3;
    printf("CBIND OK rows=%ld out=%s\n", rows, out);
    fflush(stdout);
    if (PyRun_SimpleString(
            "import json\n"
            "from cylon_tpu_torch.ops import kernels as _k\n"
            "print('LAUNCHES', json.dumps(_k.LAUNCHES), flush=True)\n"))
        return 3;

    Py_XDECREF(ctx_cls);
    Py_DECREF(ct);
    Py_DECREF(g_ctx);
    Py_DECREF(g_api);
    return Py_FinalizeEx() < 0 ? 4 : 0;
}
