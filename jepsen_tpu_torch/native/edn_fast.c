/* edn_fast: a CPython-extension EDN reader, the store's data loader.
 *
 * The batch replay parses many multi-megabyte history.edn files
 * (newline-separated op maps, store.clj:351-362's format); the Python
 * reader runs at a few MB/s, which puts the parse beside the device's
 * decision in a replay's wall. This recursive-descent reader builds
 * Python objects directly through the C API at tens of MB/s.
 *
 * It covers the grammar that history and results files use (nil, bools,
 * 64-bit ints, floats, strings, keywords, symbols, lists, vectors, maps,
 * sets, comments). Anything richer (tagged literals, char literals,
 * ratios, bignums) raises FastParseError and the Python wrapper falls
 * back to the full reader (jepsen_tpu_torch/edn.py), so the behaviour is
 * always that reader's: this is an accelerator only.
 *
 * The object mapping is configured from Python (edn_fast.configure), so
 * both readers build identical object graphs: keywords, symbols and
 * EdnList come from jepsen_tpu_torch.edn, and unhashable map keys go
 * through the same _hashable coercion.
 *
 * native/__init__.py's load_edn_fast() builds it with the system cc
 * against the running interpreter's headers into jepsen_tpu_torch/_build/.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

static PyObject *FastParseError;
static PyObject *kw_fn;        /* name -> Keyword (interned) */
static PyObject *sym_fn;       /* name -> Symbol */
static PyObject *ednlist_cls;  /* tuple -> EdnList */
static PyObject *hashable_fn;  /* form -> hashable form */

typedef struct {
    const char *s;
    Py_ssize_t i, n;
    int depth;
} P;

static PyObject *parse_form(P *p);

static void skip_ws(P *p) {
    while (p->i < p->n) {
        char c = p->s[p->i];
        if (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == ',') {
            p->i++;
        } else if (c == ';') {
            while (p->i < p->n && p->s[p->i] != '\n') p->i++;
        } else {
            break;
        }
    }
}

static int is_delim(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == ',' ||
           c == '(' || c == ')' || c == '[' || c == ']' || c == '{' ||
           c == '}' || c == '"' || c == ';' || c == '\0';
}

static PyObject *err(P *p, const char *msg) {
    PyErr_Format(FastParseError, "%s at offset %zd", msg, p->i);
    return NULL;
}

/* ---- scalars ---------------------------------------------------------- */

static PyObject *parse_string(P *p) {
    /* p->s[p->i] == '"' */
    Py_ssize_t start = ++p->i;
    /* fast path: no escapes */
    Py_ssize_t j = start;
    while (j < p->n && p->s[j] != '"' && p->s[j] != '\\') j++;
    if (j >= p->n) return err(p, "unterminated string");
    if (p->s[j] == '"') {
        PyObject *o = PyUnicode_DecodeUTF8(p->s + start, j - start, NULL);
        p->i = j + 1;
        return o;
    }
    /* slow path with escapes: build into a scratch buffer */
    Py_ssize_t cap = 64, len = 0;
    char *buf = PyMem_Malloc(cap);
    if (!buf) return PyErr_NoMemory();
    Py_ssize_t k = start;
    while (k < p->n && p->s[k] != '"') {
        char c = p->s[k];
        char out[4];
        int outn = 1;
        if (c == '\\') {
            if (++k >= p->n) { PyMem_Free(buf); return err(p, "bad escape"); }
            char e = p->s[k];
            switch (e) {
            case 'n': out[0] = '\n'; break;
            case 't': out[0] = '\t'; break;
            case 'r': out[0] = '\r'; break;
            case 'b': out[0] = '\b'; break;
            case 'f': out[0] = '\f'; break;
            case '"': out[0] = '"'; break;
            case '\\': out[0] = '\\'; break;
            case '/': out[0] = '/'; break;
            case 'u': {
                if (k + 4 >= p->n) { PyMem_Free(buf); return err(p, "bad \\u"); }
                unsigned v = 0;
                for (int h = 1; h <= 4; h++) {
                    char hc = p->s[k + h];
                    v <<= 4;
                    if (hc >= '0' && hc <= '9') v |= hc - '0';
                    else if (hc >= 'a' && hc <= 'f') v |= hc - 'a' + 10;
                    else if (hc >= 'A' && hc <= 'F') v |= hc - 'A' + 10;
                    else { PyMem_Free(buf); return err(p, "bad \\u"); }
                }
                k += 4;
                /* encode v as UTF-8 (BMP only; surrogates fall back) */
                if (v >= 0xD800 && v <= 0xDFFF) {
                    PyMem_Free(buf);
                    return err(p, "surrogate \\u");
                }
                if (v < 0x80) { out[0] = (char)v; }
                else if (v < 0x800) {
                    out[0] = (char)(0xC0 | (v >> 6));
                    out[1] = (char)(0x80 | (v & 0x3F));
                    outn = 2;
                } else {
                    out[0] = (char)(0xE0 | (v >> 12));
                    out[1] = (char)(0x80 | ((v >> 6) & 0x3F));
                    out[2] = (char)(0x80 | (v & 0x3F));
                    outn = 3;
                }
                break;
            }
            default:
                PyMem_Free(buf);
                return err(p, "unsupported escape");
            }
            k++;
        } else {
            out[0] = c;
            k++;
        }
        if (len + outn > cap) {
            cap *= 2;
            char *nb = PyMem_Realloc(buf, cap);
            if (!nb) { PyMem_Free(buf); return PyErr_NoMemory(); }
            buf = nb;
        }
        memcpy(buf + len, out, outn);
        len += outn;
    }
    if (k >= p->n) { PyMem_Free(buf); return err(p, "unterminated string"); }
    PyObject *o = PyUnicode_DecodeUTF8(buf, len, NULL);
    PyMem_Free(buf);
    p->i = k + 1;
    return o;
}

static PyObject *parse_number(P *p) {
    Py_ssize_t start = p->i;
    Py_ssize_t j = p->i;
    if (j < p->n && (p->s[j] == '+' || p->s[j] == '-')) j++;
    int is_float = 0;
    while (j < p->n && !is_delim(p->s[j])) {
        char c = p->s[j];
        if (c == '.' || c == 'e' || c == 'E') is_float = 1;
        else if (c == '/' || c == 'N' || c == 'M' || c == 'r' || c == 'R')
            return err(p, "ratio/bignum/radix literal");  /* fall back */
        else if (!((c >= '0' && c <= '9') || c == '+' || c == '-'))
            return err(p, "bad number");
        j++;
    }
    char tmp[64];
    Py_ssize_t L = j - start;
    if (L >= (Py_ssize_t)sizeof(tmp)) return err(p, "number too long");
    memcpy(tmp, p->s + start, L);
    tmp[L] = '\0';
    p->i = j;
    if (is_float) {
        char *end = NULL;
        double d = PyOS_string_to_double(tmp, &end, NULL);
        if (end != tmp + L) return err(p, "bad float");
        return PyFloat_FromDouble(d);
    }
    errno = 0;
    char *end = NULL;
    long long v = strtoll(tmp, &end, 10);
    if (errno != 0 || end != tmp + L) return err(p, "int overflow");
    return PyLong_FromLongLong(v);
}

static PyObject *parse_ident(P *p, int keyword) {
    Py_ssize_t start = p->i;
    while (p->i < p->n && !is_delim(p->s[p->i])) p->i++;
    PyObject *name = PyUnicode_DecodeUTF8(p->s + start, p->i - start, NULL);
    if (!name) return NULL;
    PyObject *out = PyObject_CallFunctionObjArgs(
        keyword ? kw_fn : sym_fn, name, NULL);
    Py_DECREF(name);
    return out;
}

/* ---- collections ------------------------------------------------------ */

static PyObject *ensure_key(PyObject *k) {
    /* Containers may hold unhashable children (a vector inside an
     * EdnList key, say); route every container through the python
     * reader's recursive _hashable coercion for identical semantics. */
    if (PyList_Check(k) || PyDict_Check(k) || PyTuple_Check(k) ||
        PyAnySet_Check(k)) {
        PyObject *hk = PyObject_CallFunctionObjArgs(hashable_fn, k, NULL);
        Py_DECREF(k);
        return hk;
    }
    return k;
}

static PyObject *parse_seq(P *p, char close, int as_ednlist) {
    p->i++;  /* opening bracket */
    PyObject *lst = PyList_New(0);
    if (!lst) return NULL;
    for (;;) {
        skip_ws(p);
        if (p->i >= p->n) { Py_DECREF(lst); return err(p, "unterminated seq"); }
        if (p->s[p->i] == close) { p->i++; break; }
        PyObject *item = parse_form(p);
        if (!item) { Py_DECREF(lst); return NULL; }
        int rc = PyList_Append(lst, item);
        Py_DECREF(item);
        if (rc < 0) { Py_DECREF(lst); return NULL; }
    }
    if (as_ednlist) {
        PyObject *tup = PyList_AsTuple(lst);
        Py_DECREF(lst);
        if (!tup) return NULL;
        PyObject *out = PyObject_CallFunctionObjArgs(ednlist_cls, tup, NULL);
        Py_DECREF(tup);
        return out;
    }
    return lst;
}

static PyObject *parse_map(P *p) {
    p->i++;  /* '{' */
    PyObject *d = PyDict_New();
    if (!d) return NULL;
    for (;;) {
        skip_ws(p);
        if (p->i >= p->n) { Py_DECREF(d); return err(p, "unterminated map"); }
        if (p->s[p->i] == '}') { p->i++; break; }
        PyObject *k = parse_form(p);
        if (!k) { Py_DECREF(d); return NULL; }
        k = ensure_key(k);
        if (!k) { Py_DECREF(d); return NULL; }
        skip_ws(p);
        if (p->i >= p->n || p->s[p->i] == '}') {
            Py_DECREF(k); Py_DECREF(d);
            return err(p, "map with odd number of forms");
        }
        PyObject *v = parse_form(p);
        if (!v) { Py_DECREF(k); Py_DECREF(d); return NULL; }
        int rc = PyDict_SetItem(d, k, v);
        Py_DECREF(k);
        Py_DECREF(v);
        if (rc < 0) { Py_DECREF(d); return NULL; }
    }
    return d;
}

static PyObject *parse_set(P *p) {
    p->i++;  /* '{' after '#' */
    PyObject *lst = PyList_New(0);
    if (!lst) return NULL;
    for (;;) {
        skip_ws(p);
        if (p->i >= p->n) { Py_DECREF(lst); return err(p, "unterminated set"); }
        if (p->s[p->i] == '}') { p->i++; break; }
        PyObject *item = parse_form(p);
        if (!item) { Py_DECREF(lst); return NULL; }
        item = ensure_key(item);
        if (!item) { Py_DECREF(lst); return NULL; }
        int rc = PyList_Append(lst, item);
        Py_DECREF(item);
        if (rc < 0) { Py_DECREF(lst); return NULL; }
    }
    PyObject *out = PyFrozenSet_New(lst);
    Py_DECREF(lst);
    return out;
}

/* ---- dispatcher ------------------------------------------------------- */

static PyObject *parse_form(P *p) {
    if (p->depth > 100) return err(p, "nesting too deep");
    skip_ws(p);
    if (p->i >= p->n) return err(p, "unexpected end of input");
    char c = p->s[p->i];
    p->depth++;
    PyObject *out = NULL;
    if (c == '"') out = parse_string(p);
    else if (c == '[') out = parse_seq(p, ']', 0);
    else if (c == '(') out = parse_seq(p, ')', 1);
    else if (c == '{') out = parse_map(p);
    else if (c == '#') {
        if (p->i + 1 < p->n && p->s[p->i + 1] == '{') {
            p->i++;
            out = parse_set(p);
        } else if (p->i + 1 < p->n && p->s[p->i + 1] == '_') {
            /* discard form: #_ <form> — parse and drop, then retry */
            p->i += 2;
            PyObject *skip = parse_form(p);
            if (skip) {
                Py_DECREF(skip);
                p->depth--;
                return parse_form(p);
            }
            out = NULL;
        } else {
            out = err(p, "tagged literal");  /* fall back to python */
        }
    }
    else if (c == ':') { p->i++; out = parse_ident(p, 1); }
    else if (c == '\\') out = err(p, "char literal");
    else if ((c >= '0' && c <= '9') ||
             ((c == '+' || c == '-') && p->i + 1 < p->n &&
              p->s[p->i + 1] >= '0' && p->s[p->i + 1] <= '9'))
        out = parse_number(p);
    else {
        /* nil / true / false / symbol */
        Py_ssize_t start = p->i;
        while (p->i < p->n && !is_delim(p->s[p->i])) p->i++;
        Py_ssize_t L = p->i - start;
        const char *w = p->s + start;
        if (L == 3 && memcmp(w, "nil", 3) == 0) { Py_INCREF(Py_None); out = Py_None; }
        else if (L == 4 && memcmp(w, "true", 4) == 0) { Py_INCREF(Py_True); out = Py_True; }
        else if (L == 5 && memcmp(w, "false", 5) == 0) { Py_INCREF(Py_False); out = Py_False; }
        else if (L == 0) out = err(p, "unexpected character");
        else {
            p->i = start;
            out = parse_ident(p, 0);
        }
    }
    p->depth--;
    return out;
}

/* ---- module API ------------------------------------------------------- */

static int get_utf8(PyObject *arg, const char **s, Py_ssize_t *n) {
    if (!PyUnicode_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "expected str");
        return -1;
    }
    *s = PyUnicode_AsUTF8AndSize(arg, n);
    return *s ? 0 : -1;
}

static PyObject *py_parse(PyObject *self, PyObject *arg) {
    const char *s; Py_ssize_t n;
    if (get_utf8(arg, &s, &n) < 0) return NULL;
    P p = {s, 0, n, 0};
    PyObject *out = parse_form(&p);
    return out;
}

static PyObject *py_parse_all(PyObject *self, PyObject *arg) {
    const char *s; Py_ssize_t n;
    if (get_utf8(arg, &s, &n) < 0) return NULL;
    P p = {s, 0, n, 0};
    PyObject *lst = PyList_New(0);
    if (!lst) return NULL;
    for (;;) {
        skip_ws(&p);
        if (p.i >= p.n) break;
        PyObject *form = parse_form(&p);
        if (!form) { Py_DECREF(lst); return NULL; }
        int rc = PyList_Append(lst, form);
        Py_DECREF(form);
        if (rc < 0) { Py_DECREF(lst); return NULL; }
    }
    return lst;
}

static PyObject *py_configure(PyObject *self, PyObject *args) {
    PyObject *k, *sy, *el, *h;
    if (!PyArg_ParseTuple(args, "OOOO", &k, &sy, &el, &h)) return NULL;
    Py_XINCREF(k); Py_XINCREF(sy); Py_XINCREF(el); Py_XINCREF(h);
    Py_XDECREF(kw_fn); Py_XDECREF(sym_fn);
    Py_XDECREF(ednlist_cls); Py_XDECREF(hashable_fn);
    kw_fn = k; sym_fn = sy; ednlist_cls = el; hashable_fn = h;
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"parse", py_parse, METH_O, "Parse the first EDN form of a string."},
    {"parse_all", py_parse_all, METH_O,
     "Parse every EDN form of a string into a list."},
    {"configure", py_configure, METH_VARARGS,
     "configure(keyword_fn, symbol_fn, ednlist_cls, hashable_fn)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "edn_fast", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit_edn_fast(void) {
    PyObject *m = PyModule_Create(&moduledef);
    if (!m) return NULL;
    FastParseError = PyErr_NewException("edn_fast.FastParseError",
                                        PyExc_ValueError, NULL);
    Py_INCREF(FastParseError);
    PyModule_AddObject(m, "FastParseError", FastParseError);
    return m;
}
