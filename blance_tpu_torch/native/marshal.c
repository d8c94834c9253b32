/* Started as a copy of native/marshal.c, with the module renamed
 * _blance_torch_marshal (PyInit__blance_torch_marshal and the module def) so
 * that it and the JAX package's _blance_marshal load side by side in one
 * process.  It differs from that file function for function: in place of
 * its max_slots + fill_prev pair the encode makes one walk (walk_prev),
 * the encode can skip sorting names already in order (in_name_order), and
 * build_map can be told which rows carry states to pass through. */

/* blance_tpu_torch native marshalling layer (CPython extension).
 *
 * The planner's compute runs on the device; at 100k partitions the end-to-end
 * wall-clock is dominated by the host-side conversion between the app's
 * string-keyed PartitionMap (the reference's data model, api.go:24-36) and
 * the dense int32 tensors the solver consumes (BASELINE.md names this the
 * next optimization after the on-device solve).  These two loops touch
 * every (partition, state, slot) cell once and are pure dict/list
 * traversal, so they live here in C:
 *
 *   in_name_order: whether the map's names are already in partition order
 *   walk_prev:  PartitionMap -> assign[P, S, R] int32 node ids, the widest
 *               row, and the rows whose source has states to pass through
 *   build_map:  per-state name rows -> {name: Partition} result map
 *
 * The input map is read once a plan, by walk_prev; build_map reads a
 * source only for the rows walk_prev marked (or for every row when the
 * caller cannot vouch that the marks describe the map it passes).
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

/* The partition-name sort key of core/order.py (_partition_name_key) of
 * the ASCII name s[0:n]: the name itself, or for a name of 1 to 18 digits
 * its number right-aligned in 10 columns with spaces (wider numbers
 * unpadded).  Points *key at it (in s, or in buf of at least 10 bytes) and
 * returns its length; -1 where only the Python rules know the key (a sign
 * before digits, or more than 18 digits). */
static Py_ssize_t
name_key(const char *s, Py_ssize_t n, char *buf, const char **key)
{
    Py_ssize_t start = (n > 0 && (s[0] == '+' || s[0] == '-')) ? 1 : 0;
    Py_ssize_t i = start;
    while (i < n && s[i] >= '0' && s[i] <= '9')
        i++;
    if (i < n || i == start) { /* not a number: the name is the key */
        *key = s;
        return n;
    }
    if (start || n > 18)
        return -1;
    Py_ssize_t z = 0;
    while (z < n - 1 && s[z] == '0')
        z++;
    Py_ssize_t len = n - z;
    if (len >= 10) {
        *key = s + z;
        return len;
    }
    memset(buf, ' ', 10 - len);
    memcpy(buf + 10 - len, s + z, len);
    *key = buf;
    return 10;
}

/* memcmp order of two byte strings, the shorter first on a common prefix. */
static int
bytes_cmp(const char *a, Py_ssize_t na, const char *b, Py_ssize_t nb)
{
    int c = memcmp(a, b, (size_t)(na < nb ? na : nb));
    if (c != 0)
        return c;
    return na < nb ? -1 : (na > nb ? 1 : 0);
}

/* in_name_order(names) -> bool
 *
 * Whether the list names is already in the planner's partition order,
 * sorted_by_partition_name's (core/order.py): strictly ascending by
 * (_partition_name_key(name), name).  A map the planner wrote is in that
 * order, so the encode can take its keys as they are instead of sorting
 * them.  False (the caller sorts) at the first pair out of order, and for
 * anything this does not decide alone: an entry that is not an ASCII str,
 * or a name whose key needs the Python rules.  For ASCII names the byte
 * order is Python's string order. */
static PyObject *
in_name_order(PyObject *self, PyObject *names)
{
    if (!PyList_Check(names)) {
        PyErr_SetString(PyExc_TypeError, "in_name_order: expected a list");
        return NULL;
    }
    Py_ssize_t P = PyList_GET_SIZE(names);
    const char *prev = NULL, *prev_key = NULL;
    Py_ssize_t prev_n = 0, prev_kn = 0;
    char bufs[2][10];
    for (Py_ssize_t pi = 0; pi < P; pi++) {
        PyObject *name = PyList_GET_ITEM(names, pi);
        if (!PyUnicode_CheckExact(name) || !PyUnicode_IS_ASCII(name))
            Py_RETURN_FALSE;
        const char *s = (const char *)PyUnicode_DATA(name);
        Py_ssize_t n = PyUnicode_GET_LENGTH(name);
        const char *key;
        Py_ssize_t kn = name_key(s, n, bufs[pi & 1], &key);
        if (kn < 0)
            Py_RETURN_FALSE;
        if (prev != NULL) {
            int c = bytes_cmp(prev_key, prev_kn, key, kn);
            if (c > 0 || (c == 0 && bytes_cmp(prev, prev_n, s, n) >= 0))
                Py_RETURN_FALSE;
        }
        prev = s;
        prev_n = n;
        prev_key = key;
        prev_kn = kn;
    }
    Py_RETURN_TRUE;
}

/* Whether the dict key at the walk's position is the partition name: the
 * same object, or two exact str objects that compare equal.  Anything else
 * (a str subclass, another type) counts as a disagreement, and the walk
 * goes back to the hashed lookup, which has the dict's own semantics. */
static int
same_name(PyObject *key, PyObject *name)
{
    if (key == name)
        return 1;
    return PyUnicode_CheckExact(key) && PyUnicode_CheckExact(name) &&
           PyUnicode_Compare(key, name) == 0;
}

/* walk_prev(buf, P, S, R, partitions, prev_map, pta, state_index,
 *           node_index, solved) -> (width, marked, keyed)
 *
 * The encode's one read of the input map.  buf: writable C-contiguous
 * int32 buffer of P*S*R elements, filled with node ids (-1 = empty).  For
 * each partition name, in order, the source Partition is prev_map's entry
 * for it, else pta's (a None entry raises AttributeError, and the caller
 * falls back to Python).  States absent from state_index and nodes
 * absent from node_index are skipped, rows cut to R (the Python encoder's
 * exact behavior, core/encode.py).
 *
 * The source is found by stepping through prev_map's entries beside the
 * names: a map the planner wrote is in the order the next encode asks for,
 * so the walk reads its entries in sequence.  From the first entry whose
 * key is not the name on, every row takes the hashed lookup.
 *
 * solved: bytes of S flags, nonzero where the state's rows are solved
 * (constraint > 0).  Returns the widest modeled row seen (the caller walks
 * again at that width when it passes R), the ascending indices of the rows
 * whose source carries a state the decode passes through (outside
 * state_index, or not solved), and the count of rows whose prev_map entry
 * was found out of step, by the hashed lookup.
 */
static PyObject *
walk_prev(PyObject *self, PyObject *args)
{
    PyObject *buf_obj, *partitions, *prev_map, *pta, *state_index;
    PyObject *node_index, *solved_obj;
    Py_ssize_t P, S, R;

    if (!PyArg_ParseTuple(args, "OnnnOOOOOO", &buf_obj, &P, &S, &R,
                          &partitions, &prev_map, &pta, &state_index,
                          &node_index, &solved_obj))
        return NULL;

    if (!PyList_Check(partitions) || !PyDict_Check(prev_map) ||
        !PyDict_Check(pta) || !PyDict_Check(state_index) ||
        !PyDict_Check(node_index) || !PyBytes_Check(solved_obj)) {
        PyErr_SetString(PyExc_TypeError, "walk_prev: unexpected arg types");
        return NULL;
    }
    if (PyList_GET_SIZE(partitions) != P ||
        PyBytes_GET_SIZE(solved_obj) != S) {
        PyErr_SetString(PyExc_ValueError,
                        "walk_prev: len(partitions) != P or len(solved) != S");
        return NULL;
    }
    const char *solved = PyBytes_AS_STRING(solved_obj);

    Py_buffer view;
    if (PyObject_GetBuffer(buf_obj, &view,
                           PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) < 0)
        return NULL;
    if (view.len != (Py_ssize_t)(P * S * R * 4) || view.itemsize != 4) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "walk_prev: buffer shape mismatch");
        return NULL;
    }
    int32_t *out = (int32_t *)view.buf;
    for (Py_ssize_t i = 0; i < P * S * R; i++)
        out[i] = -1;

    PyObject *marked = PyList_New(0);
    if (marked == NULL) {
        PyBuffer_Release(&view);
        return NULL;
    }
    Py_ssize_t width = 0, keyed = 0, pos = 0;
    int in_step = 1;

    for (Py_ssize_t pi = 0; pi < P; pi++) {
        PyObject *name = PyList_GET_ITEM(partitions, pi); /* borrowed */
        PyObject *src = NULL;
        if (in_step) {
            PyObject *key, *value;
            if (PyDict_Next(prev_map, &pos, &key, &value) &&
                same_name(key, name))
                src = value;
            else
                in_step = 0;
        }
        if (!in_step) {
            src = PyDict_GetItemWithError(prev_map, name);
            if (src != NULL)
                keyed++;
            else {
                if (PyErr_Occurred())
                    goto fail;
                src = PyDict_GetItemWithError(pta, name);
                if (src == NULL) {
                    if (PyErr_Occurred())
                        goto fail;
                    continue;
                }
            }
        }
        Py_INCREF(src);
        PyObject *nbs = PyObject_GetAttr(src, str_nodes_by_state); /* new */
        Py_DECREF(src);
        if (nbs == NULL)
            goto fail;
        if (!PyDict_Check(nbs)) {
            Py_DECREF(nbs);
            PyErr_SetString(PyExc_TypeError,
                            "walk_prev: nodes_by_state is not a dict");
            goto fail;
        }
        int passthrough = 0;
        PyObject *state, *nodes;
        Py_ssize_t spos = 0;
        while (PyDict_Next(nbs, &spos, &state, &nodes)) {
            PyObject *si_obj = PyDict_GetItemWithError(state_index, state);
            if (si_obj == NULL) {
                if (PyErr_Occurred()) {
                    Py_DECREF(nbs);
                    goto fail;
                }
                passthrough = 1; /* unmodeled: the decode keeps it */
                continue;
            }
            Py_ssize_t si = PyLong_AsSsize_t(si_obj);
            if (si == -1 && PyErr_Occurred()) {
                Py_DECREF(nbs);
                goto fail; /* non-int index: propagate (caller falls back) */
            }
            if (si < 0 || si >= S) {
                passthrough = 1;
                continue;
            }
            if (!solved[si])
                passthrough = 1; /* zero constraint: the decode keeps it */
            if (!PyList_Check(nodes)) {
                Py_DECREF(nbs);
                PyErr_SetString(PyExc_TypeError,
                                "walk_prev: node list is not a list");
                goto fail;
            }
            Py_ssize_t nn = PyList_GET_SIZE(nodes);
            if (nn > width)
                width = nn;
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
        if (passthrough) {
            PyObject *idx = PyLong_FromSsize_t(pi);
            if (idx == NULL || PyList_Append(marked, idx) < 0) {
                Py_XDECREF(idx);
                goto fail;
            }
            Py_DECREF(idx);
        }
    }

    PyBuffer_Release(&view);
    return Py_BuildValue("nNn", width, marked, keyed);

fail:
    PyBuffer_Release(&view);
    Py_DECREF(marked);
    return NULL;
}

/* The row index at *pos of the ascending list rows, past prev; -1 when the
 * list is spent, -2 (an exception set) when it holds a non-int, a negative
 * or an index that does not ascend. */
static Py_ssize_t
next_row(PyObject *rows, Py_ssize_t *pos, Py_ssize_t prev)
{
    if (*pos >= PyList_GET_SIZE(rows))
        return -1;
    Py_ssize_t row = PyLong_AsSsize_t(PyList_GET_ITEM(rows, *pos));
    if (row == -1 && PyErr_Occurred())
        return -2;
    if (row <= prev) {
        PyErr_SetString(PyExc_ValueError,
                        "build_map: read_rows must be ascending row indices");
        return -2;
    }
    (*pos)++;
    return row;
}

/* build_map(partition_cls, partitions, mod_names, rows_per_state, pta,
 *           solved_states, removed_set[, read_rows]) -> dict
 *
 * partitions: list[str] (P names, result order)
 * mod_names:  list[str] (M modeled state names)
 * rows_per_state: list of M lists, each P node-name lists (pre-trimmed)
 * pta:        dict name -> source Partition (for unmodeled-state passthrough)
 * solved_states: set of modeled state names
 * removed_set: set of removed node names (stripped from passthrough lists)
 * read_rows:  None (the default: every row's source is looked up in pta),
 *             or the ascending indices of the only rows whose source is
 *             looked up; every other row carries its solved states alone
 *
 * Returns {name: partition_cls(name, nodes_by_state_dict)}.  The fast path
 * (source has only modeled states) never allocates intermediates beyond the
 * per-partition dict.
 */
static PyObject *
build_map(PyObject *self, PyObject *args)
{
    PyObject *cls, *partitions, *mod_names, *rows_per_state, *pta;
    PyObject *solved_states, *removed_set, *read_rows = Py_None;

    if (!PyArg_ParseTuple(args, "OOOOOOO|O", &cls, &partitions, &mod_names,
                          &rows_per_state, &pta, &solved_states,
                          &removed_set, &read_rows))
        return NULL;

    if (!PyList_Check(partitions) || !PyList_Check(mod_names) ||
        !PyList_Check(rows_per_state) || !PyDict_Check(pta) ||
        !PyAnySet_Check(solved_states) || !PyAnySet_Check(removed_set) ||
        (read_rows != Py_None && !PyList_Check(read_rows))) {
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

    /* The next row whose source is looked up (-1: none left). */
    Py_ssize_t next_read = -1, read_pos = 0;
    if (read_rows != Py_None && (next_read = next_row(read_rows, &read_pos,
                                                     -1)) == -2)
        goto fail;

    for (Py_ssize_t pi = 0; pi < P; pi++) {
        PyObject *name = PyList_GET_ITEM(partitions, pi); /* borrowed */
        PyObject *nbs = PyDict_New();                     /* new */
        if (nbs == NULL)
            goto fail;

        /* Passthrough: source states outside the solved set survive, with
         * removed nodes stripped (order-preserving). */
        PyObject *src = NULL;
        if (read_rows == Py_None)
            src = PyDict_GetItemWithError(pta, name);
        else if (pi == next_read) {
            src = PyDict_GetItemWithError(pta, name);
            next_read = next_row(read_rows, &read_pos, pi);
            if (next_read == -2) {
                Py_DECREF(nbs);
                goto fail;
            }
        }
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

static PyMethodDef marshal_methods[] = {
    {"in_name_order", in_name_order, METH_O,
     "Whether a list of names is already in the planner's partition order."},
    {"walk_prev", walk_prev, METH_VARARGS,
     "Fill a dense [P, S, R] int32 buffer from a PartitionMap in one walk."},
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
