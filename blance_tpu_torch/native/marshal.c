/* Copied from native/marshal.c, with the module renamed _blance_torch_marshal
 * (PyInit__blance_torch_marshal and the module def) so that it and the
 * JAX package's _blance_marshal load side by side in one process. */

/* blance_tpu native marshalling layer (CPython extension).
 *
 * The planner's compute runs on the device; at 100k partitions the end-to-end
 * wall-clock is dominated by the host-side conversion between the app's
 * string-keyed PartitionMap (the reference's data model, api.go:24-36) and
 * the dense int32 tensors the solver consumes (BASELINE.md names this the
 * next optimization after the on-device solve).  These two loops touch
 * every (partition, state, slot) cell once and are pure dict/list
 * traversal, so they live here in C:
 *
 *   fill_prev:  PartitionMap -> assign[P, S, R] int32 node ids
 *   build_map:  per-state name rows -> {name: Partition} result map
 *
 * Loaded as a real extension module (see blance_tpu_torch/core/marshal.py), not
 * ctypes — it must traverse Python objects.  Any structural surprise
 * (non-dict nodes_by_state, non-list rows) raises, and the caller falls
 * back to the pure-Python path.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

/* Cached attribute name "nodes_by_state". */
static PyObject *str_nodes_by_state = NULL;
/* Cached attribute name "name" + a shared empty args tuple for tp_new. */
static PyObject *str_name_attr = NULL;
static PyObject *empty_args = NULL;

/* Partition construction bypasses the Python-level dataclass __init__
 * (measured: ~55% of build_map wall-clock at 100k partitions is those
 * 100k __init__ frames) when — and only when — the class is shaped like
 * the plain dataclass we ship: object's __new__, generic setattr (no
 * __slots__, not frozen), and no __post_init__ hook that skipping
 * __init__ would silence.  Anything else takes the normal call. */
static int
fast_ctor_ok(PyTypeObject *tp)
{
    if (tp->tp_new != PyBaseObject_Type.tp_new ||
        tp->tp_setattro != PyObject_GenericSetAttr)
        return 0;
    if (PyObject_HasAttrString((PyObject *)tp, "__post_init__"))
        return 0;
    /* The __init__ the normal call would run must be dataclass-generated:
     * the first class in the MRO providing __init__ must have gotten it
     * from its own @dataclass decoration (i.e. that same class's __dict__
     * also holds __dataclass_fields__).  A subclass overriding __init__
     * by hand inherits __dataclass_fields__ but defines __init__ in its
     * own __dict__ alone — skipping its validation would be silent. */
    PyObject *mro = tp->tp_mro;
    int generated = 0;
    if (mro != NULL && PyTuple_Check(mro)) {
        for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(mro); i++) {
            PyObject *c = PyTuple_GET_ITEM(mro, i);
            if (!PyType_Check(c))
                break;
            PyObject *d = ((PyTypeObject *)c)->tp_dict;
            if (d == NULL || !PyDict_Check(d))
                break;
            if (PyDict_GetItemString(d, "__init__") != NULL) {
                generated =
                    PyDict_GetItemString(d, "__dataclass_fields__") != NULL;
                break;
            }
        }
    }
    if (!generated)
        return 0;
    /* The bypass writes exactly {name, nodes_by_state}; a subclass with
     * more dataclass fields (or none — a hand-rolled class) would come
     * out partially initialized, so require that exact field set. */
    PyObject *fields =
        PyObject_GetAttrString((PyObject *)tp, "__dataclass_fields__");
    if (fields == NULL) {
        PyErr_Clear();
        return 0;
    }
    int ok = PyDict_Check(fields) && PyDict_GET_SIZE(fields) == 2 &&
             PyDict_GetItemWithError(fields, str_name_attr) != NULL &&
             PyDict_GetItemWithError(fields, str_nodes_by_state) != NULL;
    if (PyErr_Occurred()) {
        Py_DECREF(fields);
        return -1;
    }
    Py_DECREF(fields);
    return ok;
}

static PyObject *
make_partition(PyObject *cls, int fast, PyObject *name, PyObject *nbs)
{
    if (fast) {
        PyTypeObject *tp = (PyTypeObject *)cls;
        PyObject *part = tp->tp_new(tp, empty_args, NULL);
        if (part == NULL)
            return NULL;
        if (PyObject_SetAttr(part, str_name_attr, name) < 0 ||
            PyObject_SetAttr(part, str_nodes_by_state, nbs) < 0) {
            Py_DECREF(part);
            return NULL;
        }
        return part;
    }
    return PyObject_CallFunctionObjArgs(cls, name, nbs, NULL);
}

/* fill_prev(buf, P, S, R, partitions, prev_map, pta, state_index,
 *           node_index) -> None
 *
 * buf: writable C-contiguous int32 buffer of P*S*R elements; filled with
 * node ids (-1 = empty).  For each partition name, the source Partition is
 * prev_map.get(name) or pta.get(name); states absent from state_index and
 * nodes absent from node_index are skipped (the Python encoder's exact
 * behavior, core/encode.py).
 */
static PyObject *
fill_prev(PyObject *self, PyObject *args)
{
    PyObject *buf_obj, *partitions, *prev_map, *pta, *state_index, *node_index;
    Py_ssize_t P, S, R;

    if (!PyArg_ParseTuple(args, "OnnnOOOOO", &buf_obj, &P, &S, &R,
                          &partitions, &prev_map, &pta, &state_index,
                          &node_index))
        return NULL;

    if (!PyList_Check(partitions) || !PyDict_Check(prev_map) ||
        !PyDict_Check(pta) || !PyDict_Check(state_index) ||
        !PyDict_Check(node_index)) {
        PyErr_SetString(PyExc_TypeError, "fill_prev: unexpected arg types");
        return NULL;
    }
    if (PyList_GET_SIZE(partitions) != P) {
        PyErr_SetString(PyExc_ValueError, "fill_prev: len(partitions) != P");
        return NULL;
    }

    Py_buffer view;
    if (PyObject_GetBuffer(buf_obj, &view,
                           PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) < 0)
        return NULL;
    if (view.len != (Py_ssize_t)(P * S * R * 4) || view.itemsize != 4) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "fill_prev: buffer shape mismatch");
        return NULL;
    }
    int32_t *out = (int32_t *)view.buf;
    for (Py_ssize_t i = 0; i < P * S * R; i++)
        out[i] = -1;

    for (Py_ssize_t pi = 0; pi < P; pi++) {
        PyObject *name = PyList_GET_ITEM(partitions, pi); /* borrowed */
        PyObject *src = PyDict_GetItemWithError(prev_map, name);
        if (src == NULL) {
            if (PyErr_Occurred())
                goto fail;
            src = PyDict_GetItemWithError(pta, name);
            if (src == NULL) {
                if (PyErr_Occurred())
                    goto fail;
                continue;
            }
        }
        PyObject *nbs = PyObject_GetAttr(src, str_nodes_by_state); /* new */
        if (nbs == NULL)
            goto fail;
        if (!PyDict_Check(nbs)) {
            Py_DECREF(nbs);
            PyErr_SetString(PyExc_TypeError,
                            "fill_prev: nodes_by_state is not a dict");
            goto fail;
        }
        PyObject *state, *nodes;
        Py_ssize_t pos = 0;
        while (PyDict_Next(nbs, &pos, &state, &nodes)) {
            PyObject *si_obj = PyDict_GetItemWithError(state_index, state);
            if (si_obj == NULL) {
                if (PyErr_Occurred()) {
                    Py_DECREF(nbs);
                    goto fail;
                }
                continue;
            }
            Py_ssize_t si = PyLong_AsSsize_t(si_obj);
            if (si == -1 && PyErr_Occurred()) {
                Py_DECREF(nbs);
                goto fail; /* non-int index: propagate (caller falls back) */
            }
            if (si < 0 || si >= S)
                continue;
            if (!PyList_Check(nodes)) {
                Py_DECREF(nbs);
                PyErr_SetString(PyExc_TypeError,
                                "fill_prev: node list is not a list");
                goto fail;
            }
            Py_ssize_t nn = PyList_GET_SIZE(nodes);
            if (nn > R)
                nn = R;
            int32_t *row = out + (pi * S + si) * R;
            for (Py_ssize_t ri = 0; ri < nn; ri++) {
                PyObject *node = PyList_GET_ITEM(nodes, ri); /* borrowed */
                PyObject *ni_obj = PyDict_GetItemWithError(node_index, node);
                if (ni_obj == NULL) {
                    if (PyErr_Occurred()) {
                        Py_DECREF(nbs);
                        goto fail;
                    }
                    continue; /* unknown node name -> stays -1 */
                }
                long ni = PyLong_AsLong(ni_obj);
                if (ni == -1 && PyErr_Occurred()) {
                    Py_DECREF(nbs);
                    goto fail;
                }
                if (ni >= 0 && ni < INT32_MAX)
                    row[ri] = (int32_t)ni;
            }
        }
        Py_DECREF(nbs);
    }

    PyBuffer_Release(&view);
    Py_RETURN_NONE;

fail:
    PyBuffer_Release(&view);
    return NULL;
}

/* build_map(partition_cls, partitions, mod_names, rows_per_state, pta,
 *           solved_states, removed_set) -> dict
 *
 * partitions: list[str] (P names, result order)
 * mod_names:  list[str] (M modeled state names)
 * rows_per_state: list of M lists, each P node-name lists (pre-trimmed)
 * pta:        dict name -> source Partition (for unmodeled-state passthrough)
 * solved_states: set of modeled state names
 * removed_set: set of removed node names (stripped from passthrough lists)
 *
 * Returns {name: partition_cls(name, nodes_by_state_dict)}.  The fast path
 * (source has only modeled states) never allocates intermediates beyond the
 * per-partition dict.
 */
static PyObject *
build_map(PyObject *self, PyObject *args)
{
    PyObject *cls, *partitions, *mod_names, *rows_per_state, *pta;
    PyObject *solved_states, *removed_set;

    if (!PyArg_ParseTuple(args, "OOOOOOO", &cls, &partitions, &mod_names,
                          &rows_per_state, &pta, &solved_states,
                          &removed_set))
        return NULL;

    if (!PyList_Check(partitions) || !PyList_Check(mod_names) ||
        !PyList_Check(rows_per_state) || !PyDict_Check(pta) ||
        !PyAnySet_Check(solved_states) || !PyAnySet_Check(removed_set)) {
        PyErr_SetString(PyExc_TypeError, "build_map: unexpected arg types");
        return NULL;
    }

    Py_ssize_t P = PyList_GET_SIZE(partitions);
    Py_ssize_t M = PyList_GET_SIZE(mod_names);
    if (PyList_GET_SIZE(rows_per_state) != M) {
        PyErr_SetString(PyExc_ValueError,
                        "build_map: len(rows_per_state) != len(mod_names)");
        return NULL;
    }
    for (Py_ssize_t m = 0; m < M; m++) {
        PyObject *rows = PyList_GET_ITEM(rows_per_state, m);
        if (!PyList_Check(rows) || PyList_GET_SIZE(rows) != P) {
            PyErr_SetString(PyExc_ValueError,
                            "build_map: rows_per_state shape mismatch");
            return NULL;
        }
    }

    PyObject *result = PyDict_New();
    if (result == NULL)
        return NULL;

    int fast = PyType_Check(cls) ? fast_ctor_ok((PyTypeObject *)cls) : 0;
    if (fast < 0) { /* error during the probe */
        Py_DECREF(result);
        return NULL;
    }

    for (Py_ssize_t pi = 0; pi < P; pi++) {
        PyObject *name = PyList_GET_ITEM(partitions, pi); /* borrowed */
        PyObject *nbs = PyDict_New();                     /* new */
        if (nbs == NULL)
            goto fail;

        /* Passthrough: source states outside the solved set survive, with
         * removed nodes stripped (order-preserving). */
        PyObject *src = PyDict_GetItemWithError(pta, name);
        if (src == NULL && PyErr_Occurred()) {
            Py_DECREF(nbs);
            goto fail;
        }
        if (src != NULL) {
            PyObject *src_nbs = PyObject_GetAttr(src, str_nodes_by_state);
            if (src_nbs == NULL) {
                Py_DECREF(nbs);
                goto fail;
            }
            if (!PyDict_Check(src_nbs)) {
                Py_DECREF(src_nbs);
                Py_DECREF(nbs);
                PyErr_SetString(PyExc_TypeError,
                                "build_map: nodes_by_state is not a dict");
                goto fail;
            }
            PyObject *state, *nodes;
            Py_ssize_t pos = 0;
            while (PyDict_Next(src_nbs, &pos, &state, &nodes)) {
                int solved = PySet_Contains(solved_states, state);
                if (solved < 0) {
                    Py_DECREF(src_nbs);
                    Py_DECREF(nbs);
                    goto fail;
                }
                if (solved)
                    continue;
                if (!PyList_Check(nodes)) {
                    Py_DECREF(src_nbs);
                    Py_DECREF(nbs);
                    PyErr_SetString(PyExc_TypeError,
                                    "build_map: node list is not a list");
                    goto fail;
                }
                Py_ssize_t nn = PyList_GET_SIZE(nodes);
                PyObject *kept = PyList_New(0); /* new */
                if (kept == NULL) {
                    Py_DECREF(src_nbs);
                    Py_DECREF(nbs);
                    goto fail;
                }
                for (Py_ssize_t i = 0; i < nn; i++) {
                    PyObject *node = PyList_GET_ITEM(nodes, i);
                    int rem = PySet_Contains(removed_set, node);
                    if (rem < 0 || (rem == 0 &&
                                    PyList_Append(kept, node) < 0)) {
                        Py_DECREF(kept);
                        Py_DECREF(src_nbs);
                        Py_DECREF(nbs);
                        goto fail;
                    }
                }
                if (PyDict_SetItem(nbs, state, kept) < 0) {
                    Py_DECREF(kept);
                    Py_DECREF(src_nbs);
                    Py_DECREF(nbs);
                    goto fail;
                }
                Py_DECREF(kept);
            }
            Py_DECREF(src_nbs);
        }

        /* Solved states overwrite any same-named passthrough. */
        for (Py_ssize_t m = 0; m < M; m++) {
            PyObject *sname = PyList_GET_ITEM(mod_names, m);
            PyObject *rows = PyList_GET_ITEM(rows_per_state, m);
            PyObject *row = PyList_GET_ITEM(rows, pi); /* borrowed */
            if (PyDict_SetItem(nbs, sname, row) < 0) {
                Py_DECREF(nbs);
                goto fail;
            }
        }

        PyObject *part = make_partition(cls, fast, name, nbs); /* new */
        Py_DECREF(nbs);
        if (part == NULL)
            goto fail;
        if (PyDict_SetItem(result, name, part) < 0) {
            Py_DECREF(part);
            goto fail;
        }
        Py_DECREF(part);
    }

    return result;

fail:
    Py_DECREF(result);
    return NULL;
}

/* max_slots(partitions, prev_map, pta, state_index) -> int
 *
 * The widest modeled-state node list across all source partitions — the
 * R dimension scan the Python encoder does before allocating (encode.py).
 */
static PyObject *
max_slots(PyObject *self, PyObject *args)
{
    PyObject *partitions, *prev_map, *pta, *state_index;

    if (!PyArg_ParseTuple(args, "OOOO", &partitions, &prev_map, &pta,
                          &state_index))
        return NULL;
    if (!PyList_Check(partitions) || !PyDict_Check(prev_map) ||
        !PyDict_Check(pta) || !PyDict_Check(state_index)) {
        PyErr_SetString(PyExc_TypeError, "max_slots: unexpected arg types");
        return NULL;
    }

    Py_ssize_t P = PyList_GET_SIZE(partitions);
    Py_ssize_t r_max = 0;
    for (Py_ssize_t pi = 0; pi < P; pi++) {
        PyObject *name = PyList_GET_ITEM(partitions, pi);
        PyObject *src = PyDict_GetItemWithError(prev_map, name);
        if (src == NULL) {
            if (PyErr_Occurred())
                return NULL;
            src = PyDict_GetItemWithError(pta, name);
            if (src == NULL) {
                if (PyErr_Occurred())
                    return NULL;
                continue;
            }
        }
        PyObject *nbs = PyObject_GetAttr(src, str_nodes_by_state);
        if (nbs == NULL)
            return NULL;
        if (!PyDict_Check(nbs)) {
            Py_DECREF(nbs);
            PyErr_SetString(PyExc_TypeError,
                            "max_slots: nodes_by_state is not a dict");
            return NULL;
        }
        PyObject *state, *nodes;
        Py_ssize_t pos = 0;
        while (PyDict_Next(nbs, &pos, &state, &nodes)) {
            int modeled = PyDict_Contains(state_index, state);
            if (modeled < 0) {
                Py_DECREF(nbs);
                return NULL;
            }
            if (!modeled || !PyList_Check(nodes))
                continue;
            Py_ssize_t nn = PyList_GET_SIZE(nodes);
            if (nn > r_max)
                r_max = nn;
        }
        Py_DECREF(nbs);
    }
    return PyLong_FromSsize_t(r_max);
}

static PyMethodDef marshal_methods[] = {
    {"max_slots", max_slots, METH_VARARGS,
     "Widest modeled-state node list across all source partitions."},
    {"fill_prev", fill_prev, METH_VARARGS,
     "Fill a dense [P, S, R] int32 buffer from a PartitionMap."},
    {"build_map", build_map, METH_VARARGS,
     "Build a {name: Partition} map from per-state name rows."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef marshal_module = {
    PyModuleDef_HEAD_INIT,
    "_blance_torch_marshal",
    "Native PartitionMap <-> dense array marshalling.",
    -1,
    marshal_methods,
};

PyMODINIT_FUNC
PyInit__blance_torch_marshal(void)
{
    str_nodes_by_state = PyUnicode_InternFromString("nodes_by_state");
    if (str_nodes_by_state == NULL)
        return NULL;
    str_name_attr = PyUnicode_InternFromString("name");
    if (str_name_attr == NULL)
        return NULL;
    empty_args = PyTuple_New(0);
    if (empty_args == NULL)
        return NULL;
    return PyModule_Create(&marshal_module);
}
