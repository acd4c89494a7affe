/* CPython-API variant of the port's native host pack.
 *
 * Wraps hostpipe.c (textual include: one translation unit, the same
 * flags) and adds an entry point that takes a Python list of payloads
 * directly, so the JSON scan reads each payload's bytes in place
 * (PyBytes_AS_STRING) with no per-batch join and no offset/length
 * tables. native/build.py compiles this file in place of hostpipe.c
 * when sysconfig's include directory holds Python.h. The entry point
 * touches Python objects, so it is called through ctypes.PyDLL (the GIL
 * held); every other entry point keeps its CDLL binding, which releases
 * the GIL.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "hostpipe.c"

/* Parse payloads[start:n] (a list of bytes objects) into the binary
 * columns, reading each payload in place. Returns 0 when everything
 * parsed, or 1 + the index of the first payload that is not bytes or
 * falls outside the fast schema (the caller parses that one in Python
 * and resumes at index + 1): the atp_parse_json_events protocol. The
 * caller guarantees `list` is a list of length >= n that stays alive
 * for the call; items are borrowed references. */
int64_t atp_parse_json_list(PyObject *list, size_t start, size_t n,
                            uint32_t *student, uint32_t *day,
                            int64_t *micros, uint8_t *flags) {
    for (size_t i = start; i < n; ++i) {
        PyObject *o = PyList_GET_ITEM(list, (Py_ssize_t)i);
        if (!PyBytes_Check(o))
            return (int64_t)(i + 1);
        const uint8_t *p = (const uint8_t *)PyBytes_AS_STRING(o);
        size_t len = (size_t)PyBytes_GET_SIZE(o);
        if (parse_one_json_event(p, p + len, &student[i], &day[i],
                                 &micros[i], &flags[i]))
            return (int64_t)(i + 1);
    }
    return 0;
}
