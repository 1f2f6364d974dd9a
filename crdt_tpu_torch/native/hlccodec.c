/* Native batch codec for the HLC wire string
 * "YYYY-MM-DDTHH:MM:SS.mmmZ-XXXX-<node>" (hlc.dart:102-104).
 *
 * The host-side wire boundary (crdt_json.dart:8-37) is a per-record
 * string codec; at 10k+ records per sync round the Python datetime
 * round trip dominates ingest. This module batch-converts the
 * CANONICAL shape only — exactly what `Hlc.__str__` emits — and
 * returns None for anything else so the Python parser keeps full
 * reference semantics (space separators, UTC offsets, odd precision).
 *
 * Pure CPython C API, no deps; built on first use by
 * crdt_tpu/native/__init__.py with the system C compiler and loaded
 * with a silent fallback to the Python path.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

/* Howard Hinnant's civil-date algorithms (public domain), int64. */
static long long days_from_civil(long long y, int m, int d) {
    y -= m <= 2;
    long long era = (y >= 0 ? y : y - 399) / 400;
    long long yoe = y - era * 400;
    long long doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    long long doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + doe - 719468;
}

static void civil_from_days(long long z, long long *y, int *m, int *d) {
    z += 719468;
    long long era = (z >= 0 ? z : z - 146096) / 146097;
    long long doe = z - era * 146097;
    long long yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
    long long yy = yoe + era * 400;
    long long doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
    long long mp = (5 * doy + 2) / 153;
    *d = (int)(doy - (153 * mp + 2) / 5 + 1);
    *m = (int)(mp + (mp < 10 ? 3 : -9));
    *y = yy + (*m <= 2);
}

static int digits(const char *s, int n, long long *out) {
    long long v = 0;
    for (int i = 0; i < n; i++) {
        if (s[i] < '0' || s[i] > '9') return 0;
        v = v * 10 + (s[i] - '0');
    }
    *out = v;
    return 1;
}

static int hex4(const char *s, long long *out) {
    long long v = 0;
    for (int i = 0; i < 4; i++) {
        char c = s[i];
        int d;
        if (c >= '0' && c <= '9') d = c - '0';
        else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
        else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
        else return 0;
        v = v * 16 + d;
    }
    *out = v;
    return 1;
}

static int days_in_month(long long y, int m) {
    static const int dim[] = {31, 28, 31, 30, 31, 30, 31, 31, 30, 31,
                              30, 31};
    if (m == 2 && (y % 4 == 0 && (y % 100 != 0 || y % 400 == 0)))
        return 29;
    return dim[m - 1];
}

/* "YYYY-MM-DDTHH:MM:SS.mmmZ" (24 chars) -> epoch millis. 1 on success.
 * Validates calendar ranges, not just shape — an invalid date must fall
 * through to the Python parser's ValueError, never silently normalize. */
static int parse_canonical_iso(const char *s, long long *out) {
    long long y, mo, d, h, mi, sec, ms;
    if (s[4] != '-' || s[7] != '-' || s[10] != 'T' || s[13] != ':' ||
        s[16] != ':' || s[19] != '.' || s[23] != 'Z')
        return 0;
    if (!digits(s, 4, &y) || !digits(s + 5, 2, &mo) ||
        !digits(s + 8, 2, &d) || !digits(s + 11, 2, &h) ||
        !digits(s + 14, 2, &mi) || !digits(s + 17, 2, &sec) ||
        !digits(s + 20, 3, &ms))
        return 0;
    if (mo < 1 || mo > 12 || d < 1 || d > days_in_month(y, (int)mo) ||
        h > 23 || mi > 59 || sec > 59)
        return 0;
    *out = (days_from_civil(y, (int)mo, (int)d) * 86400
            + h * 3600 + mi * 60 + sec) * 1000 + ms;
    return 1;
}

/* parse_hlc_batch(list[str]) -> (list, list, list):
 * per item (millis:int, counter:int, node:str), or (None, None, None)
 * when the item is not the canonical shape (caller falls back). */
static PyObject *parse_hlc_batch(PyObject *self, PyObject *arg) {
    if (!PyList_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "expected a list of str");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(arg);
    PyObject *millis_l = PyList_New(n);
    PyObject *counter_l = PyList_New(n);
    PyObject *node_l = PyList_New(n);
    if (!millis_l || !counter_l || !node_l) goto fail;

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PyList_GET_ITEM(arg, i);
        Py_ssize_t len;
        const char *s = PyUnicode_Check(item)
            ? PyUnicode_AsUTF8AndSize(item, &len) : NULL;
        long long ms, counter;
        /* 24 iso + '-' + 4 hex + '-' + at least 1 node char */
        if (!s || len < 31 || s[24] != '-' || s[29] != '-' ||
            !parse_canonical_iso(s, &ms) || !hex4(s + 25, &counter)) {
            if (s == NULL) PyErr_Clear();
            Py_INCREF(Py_None); PyList_SET_ITEM(millis_l, i, Py_None);
            Py_INCREF(Py_None); PyList_SET_ITEM(counter_l, i, Py_None);
            Py_INCREF(Py_None); PyList_SET_ITEM(node_l, i, Py_None);
            continue;
        }
        PyObject *node = PyUnicode_FromStringAndSize(s + 30, len - 30);
        PyObject *ms_o = PyLong_FromLongLong(ms);
        PyObject *c_o = PyLong_FromLongLong(counter);
        if (!node || !ms_o || !c_o) {
            Py_XDECREF(node); Py_XDECREF(ms_o); Py_XDECREF(c_o);
            goto fail;
        }
        PyList_SET_ITEM(millis_l, i, ms_o);
        PyList_SET_ITEM(counter_l, i, c_o);
        PyList_SET_ITEM(node_l, i, node);
    }
    {
        PyObject *out = PyTuple_Pack(3, millis_l, counter_l, node_l);
        Py_DECREF(millis_l); Py_DECREF(counter_l); Py_DECREF(node_l);
        return out;
    }
fail:
    Py_XDECREF(millis_l); Py_XDECREF(counter_l); Py_XDECREF(node_l);
    return NULL;
}

/* format_hlc_batch(list[int] millis, list[int] counter, list[str] node)
 * -> list[str] "<iso>-<HEX4>-<node>"; None entries where millis is out
 * of the 4-digit-year window (caller falls back). */
static PyObject *format_hlc_batch(PyObject *self, PyObject *args) {
    PyObject *millis_l, *counter_l, *node_l;
    if (!PyArg_ParseTuple(args, "O!O!O!", &PyList_Type, &millis_l,
                          &PyList_Type, &counter_l, &PyList_Type, &node_l))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(millis_l);
    if (PyList_GET_SIZE(counter_l) != n || PyList_GET_SIZE(node_l) != n) {
        PyErr_SetString(PyExc_ValueError, "length mismatch");
        return NULL;
    }
    PyObject *out = PyList_New(n);
    if (!out) return NULL;

    for (Py_ssize_t i = 0; i < n; i++) {
        long long ms = PyLong_AsLongLong(PyList_GET_ITEM(millis_l, i));
        long long counter = PyLong_AsLongLong(PyList_GET_ITEM(counter_l, i));
        if (PyErr_Occurred()) { Py_DECREF(out); return NULL; }
        PyObject *node_o = PyList_GET_ITEM(node_l, i);
        Py_ssize_t nlen;
        const char *node = PyUnicode_AsUTF8AndSize(node_o, &nlen);
        if (!node) {
            if (PyErr_ExceptionMatches(PyExc_UnicodeEncodeError)) {
                /* lone-surrogate node id: not UTF-8 encodable, but the
                 * pure-Python formatter handles it — defer the item. */
                PyErr_Clear();
                Py_INCREF(Py_None);
                PyList_SET_ITEM(out, i, Py_None);
                continue;
            }
            Py_DECREF(out);
            return NULL;
        }

        long long secs = ms >= 0 ? ms / 1000 : (ms - 999) / 1000;
        int frac = (int)(ms - secs * 1000);
        long long days = secs >= 0 ? secs / 86400 : (secs - 86399) / 86400;
        int sod = (int)(secs - days * 86400);
        long long y; int mo, d;
        civil_from_days(days, &y, &mo, &d);
        /* y < 1 (not < 0): the pure-Python _iso8601 raises for year 0,
         * so the native formatter must defer it to that fallback — the
         * two codecs stay behaviorally identical at the boundary. */
        if (y < 1 || y > 9999 || counter < 0 || counter > 0xFFFF) {
            Py_INCREF(Py_None);
            PyList_SET_ITEM(out, i, Py_None);
            continue;
        }
        char buf[64];
        int w = snprintf(buf, sizeof buf,
                         "%04lld-%02d-%02dT%02d:%02d:%02d.%03dZ-%04llX-",
                         y, mo, d, sod / 3600, (sod / 60) % 60, sod % 60,
                         frac, counter);
        PyObject *s;
        if (PyUnicode_IS_ASCII(node_o)) {
            /* ASCII node: one allocation, two memcpys (bytes == chars) */
            s = PyUnicode_New(w + nlen, 127);
            if (s) {
                memcpy(PyUnicode_DATA(s), buf, w);
                memcpy((char *)PyUnicode_DATA(s) + w, node, nlen);
            }
        } else {
            PyObject *prefix = PyUnicode_FromStringAndSize(buf, w);
            s = prefix ? PyUnicode_Concat(prefix, node_o) : NULL;
            Py_XDECREF(prefix);
        }
        if (!s) { Py_DECREF(out); return NULL; }
        PyList_SET_ITEM(out, i, s);
    }
    return out;
}

/* ================== wire JSON scanner ==================
 *
 * parse_wire(json_str) scans the full wire payload
 * `{"key":{"hlc":"...","value":V},...}` (crdt_json.dart:8-17) in one
 * pass, returning the columnar shape the vectorized backends consume
 * without materializing the intermediate dict-of-dicts `json.loads`
 * builds:
 *
 *   (keys: list[str],
 *    lt:   bytearray of native int64 — packed (millis<<16)|counter,
 *    nodes: list[str]   (for fallback items: the raw hlc string),
 *    values: list,
 *    bad:  list[int]    (indices whose hlc was not canonical-shaped —
 *                        the caller re-parses those via Hlc.parse))
 *
 * or None when the payload deviates from the expected structure in any
 * way this scanner does not model exactly (then the caller runs the
 * plain `json.loads` path, which either handles it or raises the
 * error the user would have seen anyway). Exactness rules:
 *  - duplicate keys keep the FIRST position with the LAST value, like
 *    a Python dict build;
 *  - inner members may come in any order; unknown members are parsed
 *    (validated) and discarded; a missing "value" member decodes as
 *    None (`v.get("value")`);
 *  - number grammar is validated strictly (leading zeros etc. fall
 *    back so json.loads raises); NaN/Infinity literals are accepted
 *    exactly as Python's json does;
 *  - strings with escapes are unescaped per RFC 8259; lone surrogates
 *    (which json.loads tolerates) trigger whole-payload fallback;
 *  - nested objects/arrays are span-matched and delegated to
 *    json.loads on the substring.
 */

typedef struct {
    const char *s;
    Py_ssize_t len, pos;
    int fallback;  /* set when the payload needs the Python path */
} Scan;

static PyObject *g_json_loads = NULL;

static int ensure_json_loads(void) {
    if (g_json_loads) return 1;
    PyObject *m = PyImport_ImportModule("json");
    if (!m) return 0;
    g_json_loads = PyObject_GetAttrString(m, "loads");
    Py_DECREF(m);
    return g_json_loads != NULL;
}

static void skip_ws(Scan *sc) {
    const char *s = sc->s;
    Py_ssize_t p = sc->pos, n = sc->len;
    while (p < n) {
        char c = s[p];
        if (c != ' ' && c != '\t' && c != '\n' && c != '\r') break;
        p++;
    }
    sc->pos = p;
}

/* Content span of the JSON string starting at sc->pos (which must be
 * '"'); advances past the closing quote. Returns 0 (with sc->fallback
 * set) on malformed input. */
static int string_span(Scan *sc, Py_ssize_t *start, Py_ssize_t *end,
                       int *has_escape) {
    const char *s = sc->s;
    Py_ssize_t p = sc->pos, n = sc->len;
    if (p >= n || s[p] != '"') { sc->fallback = 1; return 0; }
    p++;
    *start = p;
    *has_escape = 0;
    while (p < n) {
        unsigned char c = (unsigned char)s[p];
        if (c == '"') {
            *end = p;
            sc->pos = p + 1;
            return 1;
        }
        if (c == '\\') {
            *has_escape = 1;
            p += 2;
            continue;
        }
        if (c < 0x20) { sc->fallback = 1; return 0; }  /* json raises */
        p++;
    }
    sc->fallback = 1;
    return 0;
}

static int hexval(char c) {
    if (c >= '0' && c <= '9') return c - '0';
    if (c >= 'a' && c <= 'f') return c - 'a' + 10;
    if (c >= 'A' && c <= 'F') return c - 'A' + 10;
    return -1;
}

/* RFC 8259 unescape of a string span into a new str object. NULL with
 * fallback=1 for anything json.loads models differently (lone
 * surrogates), NULL with an exception set on allocation failure. */
static PyObject *unescape_span(const char *p, Py_ssize_t n,
                               int *fallback) {
    char *buf = (char *)PyMem_Malloc(n > 0 ? (size_t)n : 1);
    if (!buf) { PyErr_NoMemory(); return NULL; }
    Py_ssize_t o = 0, i = 0;
    while (i < n) {
        char c = p[i];
        if (c != '\\') { buf[o++] = c; i++; continue; }
        if (i + 1 >= n) goto bad;
        char e = p[i + 1];
        i += 2;
        switch (e) {
        case '"': buf[o++] = '"'; break;
        case '\\': buf[o++] = '\\'; break;
        case '/': buf[o++] = '/'; break;
        case 'b': buf[o++] = '\b'; break;
        case 'f': buf[o++] = '\f'; break;
        case 'n': buf[o++] = '\n'; break;
        case 'r': buf[o++] = '\r'; break;
        case 't': buf[o++] = '\t'; break;
        case 'u': {
            if (i + 4 > n) goto bad;
            int h0 = hexval(p[i]), h1 = hexval(p[i + 1]);
            int h2 = hexval(p[i + 2]), h3 = hexval(p[i + 3]);
            if ((h0 | h1 | h2 | h3) < 0) goto bad;
            unsigned int cp =
                (unsigned)(h0 << 12 | h1 << 8 | h2 << 4 | h3);
            i += 4;
            if (cp >= 0xD800 && cp <= 0xDBFF) {
                /* high surrogate: need a \uDC00-\uDFFF mate */
                if (i + 6 <= n && p[i] == '\\' && p[i + 1] == 'u') {
                    int g0 = hexval(p[i + 2]), g1 = hexval(p[i + 3]);
                    int g2 = hexval(p[i + 4]), g3 = hexval(p[i + 5]);
                    unsigned int lo = (g0 | g1 | g2 | g3) < 0 ? 0 :
                        (unsigned)(g0 << 12 | g1 << 8 | g2 << 4 | g3);
                    if (lo >= 0xDC00 && lo <= 0xDFFF) {
                        cp = 0x10000 + ((cp - 0xD800) << 10)
                             + (lo - 0xDC00);
                        i += 6;
                    } else goto bad;  /* lone surrogate: json tolerates */
                } else goto bad;
            } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
                goto bad;  /* unpaired low surrogate */
            }
            /* UTF-8 encode; output never exceeds input span length */
            if (cp < 0x80) buf[o++] = (char)cp;
            else if (cp < 0x800) {
                buf[o++] = (char)(0xC0 | (cp >> 6));
                buf[o++] = (char)(0x80 | (cp & 0x3F));
            } else if (cp < 0x10000) {
                buf[o++] = (char)(0xE0 | (cp >> 12));
                buf[o++] = (char)(0x80 | ((cp >> 6) & 0x3F));
                buf[o++] = (char)(0x80 | (cp & 0x3F));
            } else {
                buf[o++] = (char)(0xF0 | (cp >> 18));
                buf[o++] = (char)(0x80 | ((cp >> 12) & 0x3F));
                buf[o++] = (char)(0x80 | ((cp >> 6) & 0x3F));
                buf[o++] = (char)(0x80 | (cp & 0x3F));
            }
            break;
        }
        default: goto bad;  /* invalid escape: json raises */
        }
    }
    {
        PyObject *out = PyUnicode_DecodeUTF8(buf, o, NULL);
        PyMem_Free(buf);
        return out;
    }
bad:
    PyMem_Free(buf);
    *fallback = 1;
    return NULL;
}

/* Skip a complete JSON value span (used for bracket matching of nested
 * containers). String-aware; does NOT validate leaf grammar. */
static int value_span(Scan *sc, Py_ssize_t *start, Py_ssize_t *end) {
    const char *s = sc->s;
    Py_ssize_t p = sc->pos, n = sc->len;
    *start = p;
    int depth = 0;
    while (p < n) {
        char c = s[p];
        if (c == '"') {
            p++;
            while (p < n) {
                if (s[p] == '\\') { p += 2; continue; }
                if (s[p] == '"') break;
                p++;
            }
            if (p >= n) { sc->fallback = 1; return 0; }
            p++;
        } else if (c == '{' || c == '[') {
            depth++; p++;
        } else if (c == '}' || c == ']') {
            depth--; p++;
            if (depth == 0) { *end = p; sc->pos = p; return 1; }
            if (depth < 0) { sc->fallback = 1; return 0; }
        } else {
            p++;
        }
        if (depth == 0 && *start != p) {
            /* scalar value: ends at , } ] or ws */
            while (p < n) {
                char d = s[p];
                if (d == ',' || d == '}' || d == ']' || d == ' ' ||
                    d == '\t' || d == '\n' || d == '\r') break;
                p++;
            }
            *end = p; sc->pos = p; return 1;
        }
    }
    sc->fallback = 1;
    return 0;
}

/* Strict JSON number at sc->pos -> int or float object, matching
 * json.loads leaf semantics. NULL + fallback on grammar violations. */
static PyObject *parse_number(Scan *sc) {
    const char *s = sc->s;
    Py_ssize_t p = sc->pos, n = sc->len, b = p;
    int isfloat = 0;
    if (p < n && s[p] == '-') p++;
    if (p >= n) { sc->fallback = 1; return NULL; }
    if (s[p] == '0') p++;
    else if (s[p] >= '1' && s[p] <= '9') {
        while (p < n && s[p] >= '0' && s[p] <= '9') p++;
    } else { sc->fallback = 1; return NULL; }
    if (p < n && s[p] == '.') {
        isfloat = 1; p++;
        if (p >= n || s[p] < '0' || s[p] > '9') {
            sc->fallback = 1; return NULL;
        }
        while (p < n && s[p] >= '0' && s[p] <= '9') p++;
    }
    if (p < n && (s[p] == 'e' || s[p] == 'E')) {
        isfloat = 1; p++;
        if (p < n && (s[p] == '+' || s[p] == '-')) p++;
        if (p >= n || s[p] < '0' || s[p] > '9') {
            sc->fallback = 1; return NULL;
        }
        while (p < n && s[p] >= '0' && s[p] <= '9') p++;
    }
    sc->pos = p;
    if (isfloat) {
        PyObject *sub = PyUnicode_FromStringAndSize(s + b, p - b);
        if (!sub) return NULL;
        PyObject *f = PyFloat_FromString(sub);
        Py_DECREF(sub);
        return f;
    }
    if (p - b < 63) {
        char buf[64];
        memcpy(buf, s + b, p - b);
        buf[p - b] = 0;
        return PyLong_FromString(buf, NULL, 10);
    }
    {
        char *hbuf = (char *)PyMem_Malloc((size_t)(p - b) + 1);
        if (!hbuf) { PyErr_NoMemory(); return NULL; }
        memcpy(hbuf, s + b, p - b);
        hbuf[p - b] = 0;
        PyObject *v = PyLong_FromString(hbuf, NULL, 10);
        PyMem_Free(hbuf);
        return v;
    }
}

static int lit(Scan *sc, const char *word, Py_ssize_t wl) {
    if (sc->pos + wl <= sc->len &&
        memcmp(sc->s + sc->pos, word, wl) == 0) {
        sc->pos += wl;
        return 1;
    }
    return 0;
}

/* Tiny string dedup cache (shared shape with the node cache below;
 * also used for object MEMBER KEYS, which repeat across records the
 * way json.loads' memo exploits). Declared ahead of the recursive
 * value parser. */
#define NCACHE 64
typedef struct {
    const char *p;
    Py_ssize_t n;
    PyObject *obj;
} NodeEnt;

static PyObject *cached_str(NodeEnt *cache, const char *p,
                            Py_ssize_t n) {
    unsigned long long h = 1469598103934665603ULL;
    for (Py_ssize_t i = 0; i < n; i++)
        h = (h ^ (unsigned char)p[i]) * 1099511628211ULL;
    NodeEnt *e = NULL;
    for (int j = 0; j < 4; j++) {   /* 4-probe: no thrash on collisions */
        NodeEnt *c = &cache[(h + (unsigned)j) & (NCACHE - 1)];
        if (!c->obj) { if (!e) e = c; continue; }
        if (c->n == n && memcmp(c->p, p, (size_t)n) == 0) {
            Py_INCREF(c->obj);
            return c->obj;
        }
    }
    if (!e) e = &cache[h & (NCACHE - 1)];
    PyObject *s = PyUnicode_FromStringAndSize(p, n);
    if (!s) return NULL;
    Py_XDECREF(e->obj);
    e->p = p; e->n = n; e->obj = s;
    Py_INCREF(s);
    return s;
}

/* Containers nested deeper than this go to json.loads on the matched
 * span (bounded C recursion; json.loads enforces Python's own limits
 * beyond it). */
#define MAX_VALUE_DEPTH 48

/* Generic JSON value -> Python object (json.loads leaf semantics),
 * recursive for flat-ish containers. NULL + sc->fallback for anything
 * deferred; NULL + exception on real errors. */
static PyObject *parse_json_value(Scan *sc, NodeEnt *kcache,
                                  int depth) {
    const char *s = sc->s;
    Py_ssize_t n = sc->len;
    if (sc->pos >= n) { sc->fallback = 1; return NULL; }
    char c = s[sc->pos];
    if (c == '"') {
        Py_ssize_t b, e; int esc;
        if (!string_span(sc, &b, &e, &esc)) return NULL;
        if (!esc) return PyUnicode_FromStringAndSize(s + b, e - b);
        return unescape_span(s + b, e - b, &sc->fallback);
    }
    if (c == '{') {
        if (depth >= MAX_VALUE_DEPTH) {
            Py_ssize_t b, e;
            if (!value_span(sc, &b, &e)) return NULL;
            if (!ensure_json_loads()) return NULL;
            return PyObject_CallFunction(g_json_loads, "s#", s + b,
                                         (Py_ssize_t)(e - b));
        }
        sc->pos++;
        PyObject *d = PyDict_New();
        if (!d) return NULL;
        skip_ws(sc);
        if (sc->pos < n && s[sc->pos] == '}') { sc->pos++; return d; }
        for (;;) {
            skip_ws(sc);
            Py_ssize_t kb, ke; int kesc;
            if (!string_span(sc, &kb, &ke, &kesc)) goto obj_fail;
            PyObject *key = kesc
                ? unescape_span(s + kb, ke - kb, &sc->fallback)
                : (ke - kb <= 48
                   ? cached_str(kcache, s + kb, ke - kb)
                   : PyUnicode_FromStringAndSize(s + kb, ke - kb));
            if (!key) goto obj_fail;
            skip_ws(sc);
            if (sc->pos >= n || s[sc->pos] != ':') {
                Py_DECREF(key); sc->fallback = 1; goto obj_fail;
            }
            sc->pos++;
            skip_ws(sc);
            PyObject *v = parse_json_value(sc, kcache, depth + 1);
            if (!v) { Py_DECREF(key); goto obj_fail; }
            int rc = PyDict_SetItem(d, key, v);
            Py_DECREF(key); Py_DECREF(v);
            if (rc < 0) goto obj_fail;
            skip_ws(sc);
            if (sc->pos < n && s[sc->pos] == ',') { sc->pos++; continue; }
            if (sc->pos < n && s[sc->pos] == '}') { sc->pos++; return d; }
            sc->fallback = 1;
            goto obj_fail;
        }
    obj_fail:
        Py_DECREF(d);
        return NULL;
    }
    if (c == '[') {
        if (depth >= MAX_VALUE_DEPTH) {
            Py_ssize_t b, e;
            if (!value_span(sc, &b, &e)) return NULL;
            if (!ensure_json_loads()) return NULL;
            return PyObject_CallFunction(g_json_loads, "s#", s + b,
                                         (Py_ssize_t)(e - b));
        }
        sc->pos++;
        PyObject *l = PyList_New(0);
        if (!l) return NULL;
        skip_ws(sc);
        if (sc->pos < n && s[sc->pos] == ']') { sc->pos++; return l; }
        for (;;) {
            skip_ws(sc);
            PyObject *v = parse_json_value(sc, kcache, depth + 1);
            if (!v) { Py_DECREF(l); return NULL; }
            int rc = PyList_Append(l, v);
            Py_DECREF(v);
            if (rc < 0) { Py_DECREF(l); return NULL; }
            skip_ws(sc);
            if (sc->pos < n && s[sc->pos] == ',') { sc->pos++; continue; }
            if (sc->pos < n && s[sc->pos] == ']') { sc->pos++; return l; }
            sc->fallback = 1;
            Py_DECREF(l);
            return NULL;
        }
    }
    if (c == '-' || (c >= '0' && c <= '9')) {
        if (c == '-' && sc->pos + 1 < n && s[sc->pos + 1] == 'I') {
            if (lit(sc, "-Infinity", 9))
                return PyFloat_FromDouble(-Py_HUGE_VAL);
            sc->fallback = 1; return NULL;
        }
        return parse_number(sc);
    }
    if (c == 't') {
        if (lit(sc, "true", 4)) Py_RETURN_TRUE;
    } else if (c == 'f') {
        if (lit(sc, "false", 5)) Py_RETURN_FALSE;
    } else if (c == 'n') {
        if (lit(sc, "null", 4)) Py_RETURN_NONE;
    } else if (c == 'N') {
        if (lit(sc, "NaN", 3)) return PyFloat_FromDouble(Py_NAN);
    } else if (c == 'I') {
        if (lit(sc, "Infinity", 8))
            return PyFloat_FromDouble(Py_HUGE_VAL);
    }
    sc->fallback = 1;
    return NULL;
}

static PyObject *parse_wire(PyObject *self, PyObject *args) {
    PyObject *arg;
    int want_hlc = 0;
    if (!PyArg_ParseTuple(args, "O|p", &arg, &want_hlc)) return NULL;
    Py_ssize_t len;
    const char *s = PyUnicode_AsUTF8AndSize(arg, &len);
    if (!s) {
        /* e.g. raw lone surrogates in the payload str: not UTF-8
         * encodable. json.loads handles those — defer, like
         * parse_hlc_batch does. */
        PyErr_Clear();
        Py_RETURN_NONE;
    }

    Scan sc = {s, len, 0, 0};
    PyObject *keys = NULL, *nodes = NULL, *values = NULL;
    PyObject *pos_map = NULL, *result = NULL, *hlcs = NULL;
    long long *lt = NULL;
    unsigned char *badf = NULL;
    Py_ssize_t cap = 0, count = 0;
    NodeEnt cache[NCACHE];
    memset(cache, 0, sizeof cache);

    keys = PyList_New(0);
    nodes = PyList_New(0);
    values = PyList_New(0);
    pos_map = PyDict_New();
    /* want_hlc: also return each record's RAW wire hlc string (None
     * for deferred items) so string-storing backends skip the
     * re-format round trip. */
    if (want_hlc) hlcs = PyList_New(0);
    if (!keys || !nodes || !values || !pos_map ||
        (want_hlc && !hlcs)) goto done;

    skip_ws(&sc);
    if (sc.pos >= len || s[sc.pos] != '{') { sc.fallback = 1; goto done; }
    sc.pos++;
    skip_ws(&sc);
    if (sc.pos < len && s[sc.pos] == '}') {
        sc.pos++;
        goto finish;
    }

    for (;;) {
        /* ---- top-level key ---- */
        skip_ws(&sc);
        Py_ssize_t kb, ke; int kesc;
        if (!string_span(&sc, &kb, &ke, &kesc)) goto done;
        PyObject *key = kesc
            ? unescape_span(s + kb, ke - kb, &sc.fallback)
            : PyUnicode_FromStringAndSize(s + kb, ke - kb);
        if (!key) goto done;
        skip_ws(&sc);
        if (sc.pos >= len || s[sc.pos] != ':') {
            Py_DECREF(key); sc.fallback = 1; goto done;
        }
        sc.pos++;
        skip_ws(&sc);

        /* ---- inner record object ---- */
        if (sc.pos >= len || s[sc.pos] != '{') {
            Py_DECREF(key); sc.fallback = 1; goto done;
        }
        sc.pos++;
        long long item_lt = 0;
        PyObject *node_obj = NULL;   /* node id, or raw hlc when bad */
        PyObject *value_obj = NULL;
        PyObject *hlc_obj = NULL;    /* raw wire hlc str (want_hlc) */
        int bad = 0, have_hlc = 0;
        skip_ws(&sc);
        if (sc.pos < len && s[sc.pos] == '}') sc.pos++;
        else for (;;) {
            skip_ws(&sc);
            Py_ssize_t mb, me; int mesc;
            if (!string_span(&sc, &mb, &me, &mesc)) goto item_fail;
            if (mesc) { sc.fallback = 1; goto item_fail; }
            skip_ws(&sc);
            if (sc.pos >= len || s[sc.pos] != ':') {
                sc.fallback = 1; goto item_fail;
            }
            sc.pos++;
            skip_ws(&sc);
            if (me - mb == 3 && memcmp(s + mb, "hlc", 3) == 0) {
                Py_ssize_t hb, he; int hesc;
                if (sc.pos >= len || s[sc.pos] != '"') {
                    sc.fallback = 1; goto item_fail;
                }
                if (!string_span(&sc, &hb, &he, &hesc)) goto item_fail;
                Py_XDECREF(node_obj);
                node_obj = NULL;
                have_hlc = 1;
                long long ms, counter;
                Py_XDECREF(hlc_obj);
                hlc_obj = NULL;
                if (!hesc && he - hb >= 31 && s[hb + 24] == '-' &&
                    s[hb + 29] == '-' &&
                    parse_canonical_iso(s + hb, &ms) &&
                    /* (ms<<16) must fit int64: the lane packing's
                     * range. Beyond it (years > ~6429) defer to the
                     * Python path, which raises OverflowError on the
                     * int64 lane instead of silently wrapping. */
                    ms <= 0x7FFFFFFFFFFFLL && ms >= -0x800000000000LL &&
                    hex4(s + hb + 25, &counter)) {
                    bad = 0;
                    item_lt = (ms << 16) | counter;
                    node_obj = cached_str(cache, s + hb + 30,
                                           he - hb - 30);
                    if (want_hlc && node_obj) {
                        /* Certify byte-equality with str(hlc): the
                         * parser accepts lowercase counter hex, but
                         * the canonical re-derive emits %04X — only
                         * uppercase spans may skip the re-format. */
                        int canon = 1;
                        for (int ci = 25; ci < 29; ci++) {
                            char hc = s[hb + ci];
                            if (hc >= 'a' && hc <= 'f') { canon = 0;
                                                          break; }
                        }
                        if (canon) {
                            hlc_obj = PyUnicode_FromStringAndSize(
                                s + hb, he - hb);
                            if (!hlc_obj) {
                                Py_DECREF(node_obj);
                                node_obj = NULL;
                            }
                        }
                    }
                } else {
                    bad = 1;
                    item_lt = 0;
                    node_obj = hesc
                        ? unescape_span(s + hb, he - hb, &sc.fallback)
                        : PyUnicode_FromStringAndSize(s + hb, he - hb);
                }
                if (!node_obj) goto item_fail;
            } else if (me - mb == 5 &&
                       memcmp(s + mb, "value", 5) == 0) {
                PyObject *v = parse_json_value(&sc, cache, 0);
                if (!v) goto item_fail;
                Py_XDECREF(value_obj);
                value_obj = v;
            } else {
                PyObject *v = parse_json_value(&sc, cache, 0);
                if (!v) goto item_fail;
                Py_DECREF(v);
            }
            skip_ws(&sc);
            if (sc.pos < len && s[sc.pos] == ',') { sc.pos++; continue; }
            if (sc.pos < len && s[sc.pos] == '}') { sc.pos++; break; }
            sc.fallback = 1;
            goto item_fail;
        }
        if (!have_hlc) { sc.fallback = 1; goto item_fail; }
        if (!value_obj) { value_obj = Py_None; Py_INCREF(Py_None); }

        /* ---- store (duplicate keys: first position, last value) ---- */
        {
            /* SetDefault = one hash probe for both lookup and insert */
            PyObject *idx = PyLong_FromSsize_t(count);
            if (!idx) goto item_fail;
            PyObject *prev = PyDict_SetDefault(pos_map, key, idx);
            if (!prev) { Py_DECREF(idx); goto item_fail; }
            if (prev != idx) {
                Py_ssize_t i = PyLong_AsSsize_t(prev);
                Py_DECREF(idx);
                lt[i] = item_lt;
                badf[i] = (unsigned char)bad;
                if (want_hlc) {
                    PyObject *h = hlc_obj ? hlc_obj : Py_None;
                    if (!hlc_obj) Py_INCREF(Py_None);
                    if (PyList_SetItem(hlcs, i, h) < 0) {
                        Py_DECREF(key);
                        goto done;
                    }
                    hlc_obj = NULL;   /* ref stolen */
                }
                if (PyList_SetItem(nodes, i, node_obj) < 0 ||
                    PyList_SetItem(values, i, value_obj) < 0) {
                    /* refs stolen even on failure path bookkeeping */
                    Py_DECREF(key);
                    goto done;
                }
                Py_DECREF(key);
            } else {
                Py_DECREF(idx);
                if (count == cap) {
                    Py_ssize_t ncap = cap ? cap * 2 : 1024;
                    long long *nlt = (long long *)PyMem_Realloc(
                        lt, (size_t)ncap * sizeof(long long));
                    unsigned char *nb = NULL;
                    if (nlt) {
                        lt = nlt;
                        nb = (unsigned char *)PyMem_Realloc(
                            badf, (size_t)ncap);
                    }
                    if (!nlt || !nb) {
                        Py_DECREF(key); Py_DECREF(node_obj);
                        Py_DECREF(value_obj);
                        PyErr_NoMemory();
                        goto done;
                    }
                    badf = nb;
                    cap = ncap;
                }
                lt[count] = item_lt;
                badf[count] = (unsigned char)bad;
                int ok =
                    PyList_Append(keys, key) == 0 &&
                    PyList_Append(nodes, node_obj) == 0 &&
                    PyList_Append(values, value_obj) == 0 &&
                    (!want_hlc || PyList_Append(
                        hlcs, hlc_obj ? hlc_obj : Py_None) == 0);
                Py_DECREF(key);
                Py_DECREF(node_obj);
                Py_DECREF(value_obj);
                Py_XDECREF(hlc_obj);
                hlc_obj = NULL;
                if (!ok) goto done;
                count++;
            }
        }
        skip_ws(&sc);
        if (sc.pos < len && s[sc.pos] == ',') { sc.pos++; continue; }
        if (sc.pos < len && s[sc.pos] == '}') { sc.pos++; break; }
        sc.fallback = 1;
        goto done;

    item_fail:
        Py_DECREF(key);
        Py_XDECREF(node_obj);
        Py_XDECREF(value_obj);
        Py_XDECREF(hlc_obj);
        goto done;
    }

finish:
    skip_ws(&sc);
    if (sc.pos != len) { sc.fallback = 1; goto done; }
    {
        PyObject *lt_buf = PyByteArray_FromStringAndSize(
            (const char *)lt, count * (Py_ssize_t)sizeof(long long));
        PyObject *badl = PyList_New(0);
        if (!lt_buf || !badl) {
            Py_XDECREF(lt_buf); Py_XDECREF(badl);
            goto done;
        }
        for (Py_ssize_t i = 0; i < count; i++) {
            if (badf[i]) {
                PyObject *ix = PyLong_FromSsize_t(i);
                if (!ix || PyList_Append(badl, ix) < 0) {
                    Py_XDECREF(ix); Py_DECREF(lt_buf);
                    Py_DECREF(badl);
                    goto done;
                }
                Py_DECREF(ix);
            }
        }
        result = want_hlc
            ? PyTuple_Pack(6, keys, lt_buf, nodes, values, badl, hlcs)
            : PyTuple_Pack(5, keys, lt_buf, nodes, values, badl);
        Py_DECREF(lt_buf);
        Py_DECREF(badl);
    }

done:
    for (int i = 0; i < NCACHE; i++) Py_XDECREF(cache[i].obj);
    PyMem_Free(lt);
    PyMem_Free(badf);
    Py_XDECREF(keys); Py_XDECREF(nodes); Py_XDECREF(values);
    Py_XDECREF(pos_map); Py_XDECREF(hlcs);
    if (result) return result;
    if (sc.fallback && !PyErr_Occurred()) Py_RETURN_NONE;
    return NULL;
}

/* parse_wire_dense(json_str) — the DenseCrdt-targeted scan of the
 * canonical int-key wire payload: besides parse_wire's one-pass
 * structure it skips EVERY per-record Python object (no key strings,
 * no value ints, no node list), emitting raw columnar buffers:
 *
 *   (slots: bytearray int32   — strictly ascending int keys,
 *    lt:    bytearray int64   — packed (millis<<16)|counter,
 *    node_idx: bytearray int32 — index into uniq_nodes,
 *    uniq_nodes: list[str]    — first-seen order, deduped,
 *    values: bytearray int64  — 0 for tombstones,
 *    tomb:  bytearray uint8,
 *    vmin: int, vmax: int)    — value range (0, 0 when all tombs)
 *
 * or None to defer to the generic path. Beyond parse_wire's fallback
 * rules it defers when: a key is not a canonical non-negative int
 * literal fitting int32, or keys are not strictly ascending (so
 * duplicate-key collapse never arises — every producer in this
 * codebase exports slot-ordered); an hlc is non-canonical; a value is
 * not an int64-range integer literal or null (floats, bools, strings,
 * containers all defer — the generic path then raises the documented
 * TypeError or handles them); more than DENSE_MAX_NODES distinct node
 * ids appear. Deferring is always semantics-preserving: the generic
 * path computes the identical result, slower. */

#define DENSE_MAX_NODES 4096
#define DENSE_NTAB 8192   /* open-address table, 2x max uniques */

typedef struct {
    const char *p;
    Py_ssize_t n;
    int idx;              /* index into uniq list; -1 = empty */
} DenseNodeEnt;

static PyObject *parse_wire_dense(PyObject *self, PyObject *arg) {
    Py_ssize_t len;
    const char *s = PyUnicode_AsUTF8AndSize(arg, &len);
    if (!s) { PyErr_Clear(); Py_RETURN_NONE; }

    Scan sc = {s, len, 0, 0};
    PyObject *uniq = NULL, *result = NULL;
    int *slots = NULL;
    long long *lt = NULL, *vals = NULL;
    int *nidx = NULL;
    unsigned char *tomb = NULL;
    DenseNodeEnt *ntab = NULL;
    Py_ssize_t cap = 0, count = 0;
    long long vmin = 0, vmax = 0;
    int have_val_range = 0;
    long long last_slot = -1;
    NodeEnt kcache[NCACHE];       /* for discarded unknown members */
    memset(kcache, 0, sizeof kcache);

    uniq = PyList_New(0);
    ntab = (DenseNodeEnt *)PyMem_Malloc(
        DENSE_NTAB * sizeof(DenseNodeEnt));
    if (!uniq || !ntab) { PyErr_NoMemory(); goto done; }
    for (int i = 0; i < DENSE_NTAB; i++) ntab[i].idx = -1;

    skip_ws(&sc);
    if (sc.pos >= len || s[sc.pos] != '{') { sc.fallback = 1; goto done; }
    sc.pos++;
    skip_ws(&sc);
    if (sc.pos < len && s[sc.pos] == '}') {
        sc.pos++;
        goto finish;
    }

    for (;;) {
        /* ---- top-level key: canonical int literal, ascending ---- */
        skip_ws(&sc);
        Py_ssize_t kb, ke; int kesc;
        if (!string_span(&sc, &kb, &ke, &kesc)) goto done;
        if (kesc || ke == kb || ke - kb > 10) { sc.fallback = 1; goto done; }
        long long slot = 0;
        {
            /* digits only, no leading zeros (except "0" itself) —
             * anything else defers so int(key) semantics stay with
             * the generic path */
            if (s[kb] == '0' && ke - kb > 1) { sc.fallback = 1; goto done; }
            for (Py_ssize_t i = kb; i < ke; i++) {
                char c = s[i];
                if (c < '0' || c > '9') { sc.fallback = 1; goto done; }
                slot = slot * 10 + (c - '0');
            }
            if (slot > 0x7FFFFFFFLL || slot <= last_slot) {
                sc.fallback = 1; goto done;
            }
            last_slot = slot;
        }
        skip_ws(&sc);
        if (sc.pos >= len || s[sc.pos] != ':') { sc.fallback = 1; goto done; }
        sc.pos++;
        skip_ws(&sc);

        /* ---- inner record object ---- */
        if (sc.pos >= len || s[sc.pos] != '{') { sc.fallback = 1; goto done; }
        sc.pos++;
        long long item_lt = 0, item_val = 0;
        int item_node = -1, item_tomb = 1, have_hlc = 0, have_value = 0;
        skip_ws(&sc);
        if (sc.pos < len && s[sc.pos] == '}') sc.pos++;
        else for (;;) {
            skip_ws(&sc);
            Py_ssize_t mb, me; int mesc;
            if (!string_span(&sc, &mb, &me, &mesc)) goto done;
            if (mesc) { sc.fallback = 1; goto done; }
            skip_ws(&sc);
            if (sc.pos >= len || s[sc.pos] != ':') {
                sc.fallback = 1; goto done;
            }
            sc.pos++;
            skip_ws(&sc);
            if (me - mb == 3 && memcmp(s + mb, "hlc", 3) == 0) {
                Py_ssize_t hb, he; int hesc;
                if (sc.pos >= len || s[sc.pos] != '"') {
                    sc.fallback = 1; goto done;
                }
                if (!string_span(&sc, &hb, &he, &hesc)) goto done;
                long long ms, counter;
                if (hesc || he - hb < 31 || s[hb + 24] != '-' ||
                    s[hb + 29] != '-' ||
                    !parse_canonical_iso(s + hb, &ms) ||
                    ms > 0x7FFFFFFFFFFFLL || ms < -0x800000000000LL ||
                    !hex4(s + hb + 25, &counter)) {
                    sc.fallback = 1; goto done;  /* non-canonical hlc */
                }
                have_hlc = 1;
                item_lt = (ms << 16) | counter;
                /* node id -> uniq index (open-address, span-keyed) */
                {
                    const char *np_ = s + hb + 30;
                    Py_ssize_t nn = he - hb - 30;
                    unsigned long long h = 1469598103934665603ULL;
                    for (Py_ssize_t i = 0; i < nn; i++)
                        h = (h ^ (unsigned char)np_[i])
                            * 1099511628211ULL;
                    Py_ssize_t probe = (Py_ssize_t)(h & (DENSE_NTAB - 1));
                    item_node = -1;
                    for (;;) {
                        DenseNodeEnt *e = &ntab[probe];
                        if (e->idx < 0) {
                            Py_ssize_t u = PyList_GET_SIZE(uniq);
                            if (u >= DENSE_MAX_NODES) {
                                sc.fallback = 1; goto done;
                            }
                            PyObject *ns = PyUnicode_FromStringAndSize(
                                np_, nn);
                            if (!ns) goto done;
                            if (PyList_Append(uniq, ns) < 0) {
                                Py_DECREF(ns); goto done;
                            }
                            Py_DECREF(ns);
                            e->p = np_; e->n = nn; e->idx = (int)u;
                            item_node = (int)u;
                            break;
                        }
                        if (e->n == nn &&
                            memcmp(e->p, np_, (size_t)nn) == 0) {
                            item_node = e->idx;
                            break;
                        }
                        probe = (probe + 1) & (DENSE_NTAB - 1);
                    }
                }
            } else if (me - mb == 5 &&
                       memcmp(s + mb, "value", 5) == 0) {
                have_value = 1;
                if (sc.pos < len && s[sc.pos] == 'n') {
                    if (!lit(&sc, "null", 4)) { sc.fallback = 1; goto done; }
                    item_tomb = 1; item_val = 0;
                } else {
                    /* strict int64 literal; anything else defers */
                    Py_ssize_t p = sc.pos;
                    int neg = 0;
                    if (p < len && s[p] == '-') { neg = 1; p++; }
                    if (p >= len || s[p] < '0' || s[p] > '9') {
                        sc.fallback = 1; goto done;
                    }
                    if (s[p] == '0' && p + 1 < len &&
                        s[p + 1] >= '0' && s[p + 1] <= '9') {
                        sc.fallback = 1; goto done;
                    }
                    unsigned long long acc = 0;
                    while (p < len && s[p] >= '0' && s[p] <= '9') {
                        unsigned long long d =
                            (unsigned long long)(s[p] - '0');
                        if (acc > (0xFFFFFFFFFFFFFFFFULL - d) / 10) {
                            sc.fallback = 1; goto done;  /* overflow */
                        }
                        acc = acc * 10 + d;
                        p++;
                    }
                    if (p < len && (s[p] == '.' || s[p] == 'e' ||
                                    s[p] == 'E')) {
                        sc.fallback = 1; goto done;  /* float literal */
                    }
                    /* int64 range check (generic path raises past it) */
                    if (neg ? acc > 0x8000000000000000ULL
                            : acc > 0x7FFFFFFFFFFFFFFFULL) {
                        sc.fallback = 1; goto done;
                    }
                    item_val = neg ? (long long)(0ULL - acc)
                                   : (long long)acc;
                    item_tomb = 0;
                    sc.pos = p;
                }
            } else {
                /* unknown member: validate + discard */
                PyObject *v = parse_json_value(&sc, kcache, 0);
                if (!v) goto done;
                Py_DECREF(v);
            }
            skip_ws(&sc);
            if (sc.pos < len && s[sc.pos] == ',') { sc.pos++; continue; }
            if (sc.pos < len && s[sc.pos] == '}') { sc.pos++; break; }
            sc.fallback = 1;
            goto done;
        }
        if (!have_hlc) { sc.fallback = 1; goto done; }
        if (!have_value) { item_tomb = 1; item_val = 0; }

        if (count == cap) {
            Py_ssize_t ncap = cap ? cap * 2 : 1024;
            int *ns_ = (int *)PyMem_Realloc(
                slots, (size_t)ncap * sizeof(int));
            if (ns_) slots = ns_;
            long long *nl = ns_ ? (long long *)PyMem_Realloc(
                lt, (size_t)ncap * sizeof(long long)) : NULL;
            if (nl) lt = nl;
            long long *nv = nl ? (long long *)PyMem_Realloc(
                vals, (size_t)ncap * sizeof(long long)) : NULL;
            if (nv) vals = nv;
            int *ni = nv ? (int *)PyMem_Realloc(
                nidx, (size_t)ncap * sizeof(int)) : NULL;
            if (ni) nidx = ni;
            unsigned char *nt = ni ? (unsigned char *)PyMem_Realloc(
                tomb, (size_t)ncap) : NULL;
            if (nt) tomb = nt;
            if (!nt) { PyErr_NoMemory(); goto done; }
            cap = ncap;
        }
        slots[count] = (int)slot;
        lt[count] = item_lt;
        vals[count] = item_val;
        nidx[count] = item_node;
        tomb[count] = (unsigned char)item_tomb;
        if (!item_tomb) {
            if (!have_val_range) {
                vmin = vmax = item_val;
                have_val_range = 1;
            } else {
                if (item_val < vmin) vmin = item_val;
                if (item_val > vmax) vmax = item_val;
            }
        }
        count++;

        skip_ws(&sc);
        if (sc.pos < len && s[sc.pos] == ',') { sc.pos++; continue; }
        if (sc.pos < len && s[sc.pos] == '}') { sc.pos++; break; }
        sc.fallback = 1;
        goto done;
    }

finish:
    skip_ws(&sc);
    if (sc.pos != len) { sc.fallback = 1; goto done; }
    {
        PyObject *slot_buf = PyByteArray_FromStringAndSize(
            (const char *)slots, count * (Py_ssize_t)sizeof(int));
        PyObject *lt_buf = PyByteArray_FromStringAndSize(
            (const char *)lt, count * (Py_ssize_t)sizeof(long long));
        PyObject *nidx_buf = PyByteArray_FromStringAndSize(
            (const char *)nidx, count * (Py_ssize_t)sizeof(int));
        PyObject *val_buf = PyByteArray_FromStringAndSize(
            (const char *)vals, count * (Py_ssize_t)sizeof(long long));
        PyObject *tomb_buf = PyByteArray_FromStringAndSize(
            (const char *)tomb, count);
        PyObject *vmin_o = PyLong_FromLongLong(vmin);
        PyObject *vmax_o = PyLong_FromLongLong(vmax);
        if (slot_buf && lt_buf && nidx_buf && val_buf && tomb_buf &&
            vmin_o && vmax_o)
            result = PyTuple_Pack(8, slot_buf, lt_buf, nidx_buf, uniq,
                                  val_buf, tomb_buf, vmin_o, vmax_o);
        Py_XDECREF(slot_buf); Py_XDECREF(lt_buf); Py_XDECREF(nidx_buf);
        Py_XDECREF(val_buf); Py_XDECREF(tomb_buf);
        Py_XDECREF(vmin_o); Py_XDECREF(vmax_o);
    }

done:
    for (int i = 0; i < NCACHE; i++) Py_XDECREF(kcache[i].obj);
    PyMem_Free(slots); PyMem_Free(lt); PyMem_Free(vals);
    PyMem_Free(nidx); PyMem_Free(tomb); PyMem_Free(ntab);
    Py_XDECREF(uniq);
    if (result) return result;
    if (sc.fallback && !PyErr_Occurred()) Py_RETURN_NONE;
    return NULL;
}

/* ================== host-runtime batch helpers ==================
 *
 * The vectorized backends keep key->slot maps and payload tables as
 * Python dict/list (keys and values are arbitrary Python objects);
 * these helpers run their per-record bookkeeping loops in C. Same
 * semantics as the straightforward Python loops, minus the
 * interpreter dispatch — at 1M records the ensure-slots loop alone
 * is ~1.8 s of a 3.2 s wire merge. */

/* ordinals(node_ids: list, omap: dict) -> bytearray of int32
 * Batched ordinal lookup: out[i] = omap[node_ids[i]]. An identity
 * memo skips the dict probe for consecutive repeats (the wire
 * scanners dedup node strings, so runs share one object). KeyError
 * on a missing id, like the Python dict lookup it replaces. */
static PyObject *ordinals(PyObject *self, PyObject *args) {
    PyObject *ids, *omap;
    if (!PyArg_ParseTuple(args, "O!O!", &PyList_Type, &ids,
                          &PyDict_Type, &omap)) return NULL;
    Py_ssize_t m = PyList_GET_SIZE(ids);
    PyObject *buf = PyByteArray_FromStringAndSize(
        NULL, m * (Py_ssize_t)sizeof(int32_t));
    if (!buf) return NULL;
    int32_t *out = (int32_t *)PyByteArray_AS_STRING(buf);
    PyObject *prev = NULL;
    int32_t prev_ord = 0;
    for (Py_ssize_t i = 0; i < m; i++) {
        PyObject *k = PyList_GET_ITEM(ids, i);
        if (k == prev) {
            out[i] = prev_ord;
            continue;
        }
        PyObject *v = PyDict_GetItemWithError(omap, k);
        if (!v) {
            if (!PyErr_Occurred())
                PyErr_SetObject(PyExc_KeyError, k);
            Py_DECREF(buf);
            return NULL;
        }
        long o = PyLong_AsLong(v);
        if (o == -1 && PyErr_Occurred()) {
            Py_DECREF(buf);
            return NULL;
        }
        out[i] = (int32_t)o;
        prev = k;
        prev_ord = (int32_t)o;
    }
    return buf;
}


/* ensure_slots(key_to_slot: dict, keys: list, start: int)
 * -> (bytearray of int64 slots, new_keys: list)
 * Get-or-insert each key; fresh keys take consecutive slots from
 * `start` in list order and are returned so the caller can extend its
 * slot->key / payload tables. */
static PyObject *ensure_slots(PyObject *self, PyObject *args) {
    PyObject *map, *keys;
    Py_ssize_t start;
    if (!PyArg_ParseTuple(args, "O!O!n", &PyDict_Type, &map,
                          &PyList_Type, &keys, &start))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(keys);
    PyObject *buf = PyByteArray_FromStringAndSize(
        NULL, n * (Py_ssize_t)sizeof(long long));
    PyObject *new_keys = PyList_New(0);
    if (!buf || !new_keys) goto fail;
    long long *slots = (long long *)PyByteArray_AS_STRING(buf);
    Py_ssize_t next = start;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *key = PyList_GET_ITEM(keys, i);
        PyObject *idx = PyLong_FromSsize_t(next);
        if (!idx) goto fail;
        PyObject *prev = PyDict_SetDefault(map, key, idx);
        if (!prev) { Py_DECREF(idx); goto fail; }
        if (prev == idx) {
            if (PyList_Append(new_keys, key) < 0) {
                /* the key IS in the dict but won't make new_keys, so
                 * the rollback loop below would miss it — undo the
                 * insert here (preserving the append's exception). */
                PyObject *et, *ev, *tb;
                PyErr_Fetch(&et, &ev, &tb);
                if (PyDict_DelItem(map, key) < 0) PyErr_Clear();
                PyErr_Restore(et, ev, tb);
                Py_DECREF(idx);
                goto fail;
            }
            slots[i] = (long long)next;
            next++;
        } else {
            slots[i] = PyLong_AsLongLong(prev);
            if (slots[i] == -1 && PyErr_Occurred()) {
                Py_DECREF(idx); goto fail;
            }
        }
        Py_DECREF(idx);
    }
    {
        PyObject *out = PyTuple_Pack(2, buf, new_keys);
        Py_DECREF(buf); Py_DECREF(new_keys);
        return out;
    }
fail:
    /* Exception safety: the caller extends its slot->key/payload
     * tables only on success, so any keys this batch already inserted
     * into the shared dict must be rolled back — otherwise the next
     * batch re-issues their slot numbers and two keys silently share
     * one lane slot. */
    if (new_keys) {
        PyObject *etype, *eval, *etb;
        PyErr_Fetch(&etype, &eval, &etb);
        for (Py_ssize_t i = 0; i < PyList_GET_SIZE(new_keys); i++) {
            if (PyDict_DelItem(map, PyList_GET_ITEM(new_keys, i)) < 0)
                PyErr_Clear();
        }
        PyErr_Restore(etype, eval, etb);
    }
    Py_XDECREF(buf); Py_XDECREF(new_keys);
    return NULL;
}

/* none_mask(values: list) -> bytearray of uint8 (1 where item is None)
 * — the tombstone lane build (value == null, record.dart:17). */
static PyObject *none_mask(PyObject *self, PyObject *arg) {
    if (!PyList_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "expected a list");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(arg);
    PyObject *buf = PyByteArray_FromStringAndSize(NULL, n);
    if (!buf) return NULL;
    char *m = PyByteArray_AS_STRING(buf);
    for (Py_ssize_t i = 0; i < n; i++)
        m[i] = PyList_GET_ITEM(arg, i) == Py_None;
    return buf;
}

/* 8-byte signed-integer buffer check: format 'q'/'l' (64-bit
 * platforms), optionally '@'-prefixed (native order/size). */
static int wire_is_i64_buffer(const Py_buffer *b) {
    const char *f = b->format;
    if (b->itemsize != (Py_ssize_t)sizeof(long long) ||
        b->len % (Py_ssize_t)sizeof(long long))
        return 0;
    if (!f) return 0;
    if (*f == '@') f++;
    return (f[0] == 'q' || f[0] == 'l') && f[1] == '\0';
}

/* scatter_payload(payload: list, slots: int64 buffer,
 *                 winners: int64 buffer, values: list) -> None
 * payload[slots[w]] = values[w] for each winner index w. */
static PyObject *scatter_payload(PyObject *self, PyObject *args) {
    PyObject *payload, *slots_o, *win_o, *values;
    if (!PyArg_ParseTuple(args, "O!OOO!", &PyList_Type, &payload,
                          &slots_o, &win_o, &PyList_Type, &values))
        return NULL;
    Py_buffer slots_b, win_b;
    if (PyObject_GetBuffer(slots_o, &slots_b,
                           PyBUF_CONTIG_RO | PyBUF_FORMAT) < 0)
        return NULL;
    if (PyObject_GetBuffer(win_o, &win_b,
                           PyBUF_CONTIG_RO | PyBUF_FORMAT) < 0) {
        PyBuffer_Release(&slots_b);
        return NULL;
    }
    /* The casts below assume int64 elements; any other item type (an
     * int32 ndarray, a float64 ndarray — same width, different bits)
     * would silently misindex the payload list instead of erroring. */
    if (!wire_is_i64_buffer(&slots_b) || !wire_is_i64_buffer(&win_b)) {
        PyBuffer_Release(&slots_b); PyBuffer_Release(&win_b);
        PyErr_SetString(PyExc_TypeError,
                        "scatter_payload needs int64 slot/winner buffers");
        return NULL;
    }
    const long long *slots = (const long long *)slots_b.buf;
    const long long *win = (const long long *)win_b.buf;
    Py_ssize_t n_slots_arr = slots_b.len / (Py_ssize_t)sizeof(long long);
    Py_ssize_t n_win = win_b.len / (Py_ssize_t)sizeof(long long);
    Py_ssize_t n_pay = PyList_GET_SIZE(payload);
    Py_ssize_t n_val = PyList_GET_SIZE(values);
    for (Py_ssize_t i = 0; i < n_win; i++) {
        long long w = win[i];
        if (w < 0 || w >= n_slots_arr || w >= n_val ||
            slots[w] < 0 || slots[w] >= n_pay) {
            PyBuffer_Release(&slots_b); PyBuffer_Release(&win_b);
            PyErr_SetString(PyExc_IndexError,
                            "scatter_payload index out of range");
            return NULL;
        }
        PyObject *v = PyList_GET_ITEM(values, w);
        Py_INCREF(v);
        PyObject *old = PyList_GET_ITEM(payload, slots[w]);
        PyList_SET_ITEM(payload, slots[w], v);
        Py_XDECREF(old);
    }
    PyBuffer_Release(&slots_b); PyBuffer_Release(&win_b);
    Py_RETURN_NONE;
}

/* ================== wire JSON assembler ==================
 *
 * format_wire(keys, hlcs, values, dumps) -> str | None
 * Assembles `{"key":{"hlc":"...","value":V},...}` from parallel lists
 * in one pass, byte-identical to
 *   json.dumps(obj, separators=(",",":"), ensure_ascii=False, ...)
 * over the dict the Python paths would build. Keys are str (already
 * stringified by the caller) or int (dense slot exports); hlc strings
 * come from format_hlc_batch; scalar values (None/bool/int/float/str)
 * serialize natively, anything else goes through the `dumps` callable
 * (so custom to_json hooks keep working). Returns None only for
 * argument shapes it does not model (caller falls back). */

typedef struct {
    char *p;
    size_t len, cap;
} WBuf;

/* UTF-8 view of a str, or NULL. Lone surrogates are not UTF-8
 * encodable but json.dumps(ensure_ascii=False) still serializes
 * them — so on UnicodeEncodeError set *defer (caller returns None
 * for the whole payload and the Python path takes over), matching
 * parse_wire's precedent. Other errors propagate. */
static const char *wire_utf8(PyObject *o, Py_ssize_t *n, int *defer) {
    const char *u = PyUnicode_AsUTF8AndSize(o, n);
    if (!u && PyErr_ExceptionMatches(PyExc_UnicodeEncodeError)) {
        PyErr_Clear();
        *defer = 1;
    }
    return u;
}

static int wbuf_grow(WBuf *b, size_t need) {
    if (b->len + need <= b->cap) return 1;
    size_t ncap = b->cap ? b->cap : 4096;
    while (b->len + need > ncap) ncap *= 2;
    char *np = (char *)PyMem_Realloc(b->p, ncap);
    if (!np) { PyErr_NoMemory(); return 0; }
    b->p = np; b->cap = ncap;
    return 1;
}

static int wbuf_put(WBuf *b, const char *s, size_t n) {
    if (!wbuf_grow(b, n)) return 0;
    memcpy(b->p + b->len, s, n);
    b->len += n;
    return 1;
}

/* JSON string-escape (ensure_ascii=False rules: escape ", backslash,
 * and control chars — \b \t \n \f \r short forms, \u00XX otherwise;
 * non-ASCII passes through as raw UTF-8). */
static int wbuf_put_escaped(WBuf *b, const char *s, Py_ssize_t n) {
    if (!wbuf_grow(b, (size_t)n + 2)) return 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        unsigned char c = (unsigned char)s[i];
        if (c == '"' || c == '\\') {
            char e[2] = {'\\', (char)c};
            if (!wbuf_put(b, e, 2)) return 0;
        } else if (c >= 0x20) {
            if (!wbuf_grow(b, 1)) return 0;
            b->p[b->len++] = (char)c;
        } else {
            char e[8];
            int w;
            switch (c) {
            case '\b': memcpy(e, "\\b", 2); w = 2; break;
            case '\t': memcpy(e, "\\t", 2); w = 2; break;
            case '\n': memcpy(e, "\\n", 2); w = 2; break;
            case '\f': memcpy(e, "\\f", 2); w = 2; break;
            case '\r': memcpy(e, "\\r", 2); w = 2; break;
            default:
                w = snprintf(e, sizeof e, "\\u%04x", c);
            }
            if (!wbuf_put(b, e, (size_t)w)) return 0;
        }
    }
    return 1;
}

/* One JSON value; 1 on success, 0 on error, -1 when the caller must
 * use the dumps fallback for this value. */
static int wbuf_put_scalar(WBuf *b, PyObject *v) {
    if (v == Py_None) return wbuf_put(b, "null", 4);
    if (v == Py_True) return wbuf_put(b, "true", 4);
    if (v == Py_False) return wbuf_put(b, "false", 5);
    if (PyLong_CheckExact(v)) {
        int overflow = 0;
        long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
        if (!overflow) {
            if (x == -1 && PyErr_Occurred()) return 0;
            char d[32];
            return wbuf_put(b, d, (size_t)snprintf(d, sizeof d,
                                                   "%lld", x));
        }
        PyObject *s = PyObject_Str(v);   /* big int */
        if (!s) return 0;
        Py_ssize_t n;
        const char *u = PyUnicode_AsUTF8AndSize(s, &n);
        int ok = u && wbuf_put(b, u, (size_t)n);
        Py_DECREF(s);
        return ok;
    }
    if (PyFloat_CheckExact(v)) {
        double x = PyFloat_AS_DOUBLE(v);
        /* json.dumps default: allow_nan=True emits these literals */
        if (x != x) return wbuf_put(b, "NaN", 3);
        if (x > 1.7976931348623157e308)
            return wbuf_put(b, "Infinity", 8);
        if (x < -1.7976931348623157e308)
            return wbuf_put(b, "-Infinity", 9);
        char *r = PyOS_double_to_string(x, 'r', 0, Py_DTSF_ADD_DOT_0,
                                        NULL);
        if (!r) return 0;
        int ok = wbuf_put(b, r, strlen(r));
        PyMem_Free(r);
        return ok;
    }
    if (PyUnicode_CheckExact(v)) {
        Py_ssize_t n;
        int defer = 0;
        const char *u = wire_utf8(v, &n, &defer);
        if (!u) return defer ? -2 : 0;
        return (wbuf_put(b, "\"", 1) && wbuf_put_escaped(b, u, n)
                && wbuf_put(b, "\"", 1));
    }
    return -1;   /* container / custom object: dumps fallback */
}

/* dumps() a subtree via the Python callable and splice the text in.
 * Returns 1 ok, 0 error, -2 defer (lone-surrogate output). */
static int wbuf_splice_dumps(WBuf *b, PyObject *v, PyObject *dumps) {
    PyObject *s = PyObject_CallFunctionObjArgs(dumps, v, NULL);
    if (!s) return 0;
    Py_ssize_t n;
    int defer = 0;
    const char *u = PyUnicode_CheckExact(s) ? wire_utf8(s, &n, &defer)
                                            : NULL;
    int ok = u && wbuf_put(b, u, (size_t)n);
    Py_DECREF(s);
    if (!ok) return defer ? -2 : 0;
    return 1;
}

/* Recursive compact JSON writer: scalars via wbuf_put_scalar, exact
 * dict/list/tuple walked natively with compact separators (the
 * `compact_dumps` wire style, ensure_ascii=False); anything else —
 * custom objects, str/int subclasses, dict keys that are not exact
 * str, nesting past the cap — is serialized by the `dumps` callable
 * and spliced in (partial native output is truncated first, so the
 * splice never duplicates bytes). Returns 1 ok, 0 error, -2 defer
 * (lone surrogate: the caller runs its whole-payload fallback). */
#define WIRE_MAX_DEPTH 64
static int wbuf_put_json(WBuf *b, PyObject *v, PyObject *dumps,
                         int depth) {
    int rc = wbuf_put_scalar(b, v);
    if (rc >= 0 || rc == -2) return rc == -2 ? -2 : rc;
    size_t start = b->len;
    if (depth < WIRE_MAX_DEPTH && PyDict_CheckExact(v)) {
        if (!wbuf_put(b, "{", 1)) return 0;
        Py_ssize_t pos = 0, i = 0;
        PyObject *k, *val;
        while (PyDict_Next(v, &pos, &k, &val)) {
            if (!PyUnicode_CheckExact(k)) {
                b->len = start;   /* non-str key: dumps whole dict */
                return wbuf_splice_dumps(b, v, dumps);
            }
            if (i++ && !wbuf_put(b, ",", 1)) return 0;
            Py_ssize_t kn;
            int kdefer = 0;
            const char *ku = wire_utf8(k, &kn, &kdefer);
            if (!ku) return kdefer ? -2 : 0;
            if (!wbuf_put(b, "\"", 1) ||
                !wbuf_put_escaped(b, ku, kn) ||
                !wbuf_put(b, "\":", 2)) return 0;
            int r = wbuf_put_json(b, val, dumps, depth + 1);
            if (r != 1) return r;
        }
        return wbuf_put(b, "}", 1);
    }
    if (depth < WIRE_MAX_DEPTH &&
        (PyList_CheckExact(v) || PyTuple_CheckExact(v))) {
        if (!wbuf_put(b, "[", 1)) return 0;
        Py_ssize_t n = PySequence_Fast_GET_SIZE(v);
        for (Py_ssize_t i = 0; i < n; i++) {
            if (i && !wbuf_put(b, ",", 1)) return 0;
            int r = wbuf_put_json(b, PySequence_Fast_GET_ITEM(v, i),
                                  dumps, depth + 1);
            if (r != 1) return r;
        }
        return wbuf_put(b, "]", 1);
    }
    return wbuf_splice_dumps(b, v, dumps);
}

static PyObject *format_wire(PyObject *self, PyObject *args) {
    PyObject *keys, *hlcs, *values, *dumps;
    if (!PyArg_ParseTuple(args, "O!O!O!O", &PyList_Type, &keys,
                          &PyList_Type, &hlcs, &PyList_Type, &values,
                          &dumps))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(keys);
    if (PyList_GET_SIZE(hlcs) != n || PyList_GET_SIZE(values) != n) {
        PyErr_SetString(PyExc_ValueError, "length mismatch");
        return NULL;
    }
    WBuf b = {NULL, 0, 0};
    if (!wbuf_put(&b, "{", 1)) goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        if (i && !wbuf_put(&b, ",", 1)) goto fail;
        PyObject *key = PyList_GET_ITEM(keys, i);
        if (PyUnicode_CheckExact(key)) {
            Py_ssize_t kn;
            int kdefer = 0;
            const char *ku = wire_utf8(key, &kn, &kdefer);
            if (!ku) {
                if (kdefer) { PyMem_Free(b.p); Py_RETURN_NONE; }
                goto fail;
            }
            if (!wbuf_put(&b, "\"", 1) ||
                !wbuf_put_escaped(&b, ku, kn) ||
                !wbuf_put(&b, "\"", 1)) goto fail;
        } else if (PyLong_CheckExact(key)) {
            int overflow = 0;
            long long x = PyLong_AsLongLongAndOverflow(key, &overflow);
            if (overflow || (x == -1 && PyErr_Occurred())) {
                PyErr_Clear();
                PyMem_Free(b.p);
                Py_RETURN_NONE;   /* exotic key: caller falls back */
            }
            char d[36];
            int w = snprintf(d, sizeof d, "\"%lld\"", x);
            if (!wbuf_put(&b, d, (size_t)w)) goto fail;
        } else {
            PyMem_Free(b.p);
            Py_RETURN_NONE;       /* caller stringifies, then retries */
        }
        if (!wbuf_put(&b, ":{\"hlc\":\"", 9)) goto fail;
        PyObject *h = PyList_GET_ITEM(hlcs, i);
        Py_ssize_t hn;
        int hdefer = 0;
        const char *hu = PyUnicode_CheckExact(h)
            ? wire_utf8(h, &hn, &hdefer) : NULL;
        if (!hu) {
            if (hdefer) { PyMem_Free(b.p); Py_RETURN_NONE; }
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_TypeError, "hlc must be str");
            goto fail;
        }
        if (!wbuf_put_escaped(&b, hu, hn)) goto fail;
        if (!wbuf_put(&b, "\",\"value\":", 10)) goto fail;
        PyObject *v = PyList_GET_ITEM(values, i);
        int rc = wbuf_put_json(&b, v, dumps, 0);
        if (rc == 0) goto fail;
        if (rc == -2) { PyMem_Free(b.p); Py_RETURN_NONE; }
        if (!wbuf_put(&b, "}", 1)) goto fail;
    }
    if (!wbuf_put(&b, "}", 1)) goto fail;
    {
        PyObject *out = PyUnicode_DecodeUTF8(b.p, (Py_ssize_t)b.len,
                                             NULL);
        PyMem_Free(b.p);
        return out;
    }
fail:
    PyMem_Free(b.p);
    return NULL;
}

/* dump_values(values: list, dumps) -> list[str]
 * Batch JSON text for a value column: each value serialized compact
 * (the wbuf_put_json writer); items the native writer can't emit
 * as UTF-8 (lone surrogates) fall back to the `dumps` callable per
 * item — pass a json.dumps that can represent them (ensure_ascii).
 * Scalar/container coverage matches format_wire's value field. */
static PyObject *dump_values(PyObject *self, PyObject *args) {
    PyObject *values, *dumps;
    if (!PyArg_ParseTuple(args, "O!O", &PyList_Type, &values, &dumps))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(values);
    PyObject *out = PyList_New(n);
    if (!out) return NULL;
    WBuf b = {NULL, 0, 0};
    for (Py_ssize_t i = 0; i < n; i++) {
        b.len = 0;
        PyObject *v = PyList_GET_ITEM(values, i);
        int rc = wbuf_put_json(&b, v, dumps, 0);
        PyObject *s;
        if (rc == 1) {
            s = PyUnicode_DecodeUTF8(b.p, (Py_ssize_t)b.len, NULL);
        } else if (rc == -2) {
            PyErr_Clear();
            s = PyObject_CallFunctionObjArgs(dumps, v, NULL);
        } else {
            s = NULL;
        }
        if (!s) { PyMem_Free(b.p); Py_DECREF(out); return NULL; }
        PyList_SET_ITEM(out, i, s);
    }
    PyMem_Free(b.p);
    return out;
}

/* records_to_columns(records: list[Record], with_modified: bool)
 * -> (lt: bytearray int64, nodes: list, values: list
 *     [, mod_lt: bytearray int64, mod_nodes: list])
 * Batch attribute extraction for the record-dict API surface: each
 * Record carries (hlc, value, modified) with hlc = (millis, counter,
 * node_id). lt packs (millis << 16) | counter; millis outside the
 * int64 lane range raises OverflowError (the columnar contract —
 * matching np.fromiter over .logical_time). */
static PyObject *s_hlc, *s_millis, *s_counter, *s_node_id,
                *s_value, *s_modified;

static int ensure_attr_names(void) {
    if (s_hlc) return 1;
    s_hlc = PyUnicode_InternFromString("hlc");
    s_millis = PyUnicode_InternFromString("millis");
    s_counter = PyUnicode_InternFromString("counter");
    s_node_id = PyUnicode_InternFromString("node_id");
    s_value = PyUnicode_InternFromString("value");
    s_modified = PyUnicode_InternFromString("modified");
    return (s_hlc && s_millis && s_counter && s_node_id && s_value
            && s_modified);
}

static PyObject *records_to_columns(PyObject *self, PyObject *args) {
    PyObject *records;
    if (!ensure_attr_names()) return NULL;
    int with_modified = 0;
    if (!PyArg_ParseTuple(args, "O!p", &PyList_Type, &records,
                          &with_modified))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(records);
    PyObject *lt_buf = PyByteArray_FromStringAndSize(
        NULL, n * (Py_ssize_t)sizeof(long long));
    PyObject *nodes = PyList_New(n);
    PyObject *values = PyList_New(n);
    PyObject *mlt_buf = NULL, *mnodes = NULL, *result = NULL;
    if (with_modified) {
        mlt_buf = PyByteArray_FromStringAndSize(
            NULL, n * (Py_ssize_t)sizeof(long long));
        mnodes = PyList_New(n);
        if (!mlt_buf || !mnodes) goto done;
    }
    if (!lt_buf || !nodes || !values) goto done;
    long long *lt = (long long *)PyByteArray_AS_STRING(lt_buf);
    long long *mlt = with_modified
        ? (long long *)PyByteArray_AS_STRING(mlt_buf) : NULL;

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *r = PyList_GET_ITEM(records, i);
        PyObject *hlc = PyObject_GetAttr(r, s_hlc);
        if (!hlc) goto done;
        PyObject *ms_o = PyObject_GetAttr(hlc, s_millis);
        PyObject *c_o = ms_o ? PyObject_GetAttr(hlc, s_counter)
                             : NULL;
        PyObject *node = c_o ? PyObject_GetAttr(hlc, s_node_id)
                             : NULL;
        Py_DECREF(hlc);
        if (!node) {
            Py_XDECREF(ms_o); Py_XDECREF(c_o);
            goto done;
        }
        long long ms = PyLong_AsLongLong(ms_o);
        Py_DECREF(ms_o);
        if (ms == -1 && PyErr_Occurred()) {   /* no API call with an
                                               * exception pending */
            Py_DECREF(c_o); Py_DECREF(node); goto done;
        }
        long long counter = PyLong_AsLongLong(c_o);
        Py_DECREF(c_o);
        if (counter == -1 && PyErr_Occurred()) {
            Py_DECREF(node); goto done;
        }
        if (ms > 0x7FFFFFFFFFFFLL || ms < -0x800000000000LL) {
            Py_DECREF(node);
            PyErr_SetString(PyExc_OverflowError,
                            "HLC millis outside the int64 lane range "
                            "(|millis| >= 2^47)");
            goto done;
        }
        /* + not |: matches .logical_time exactly even for
         * out-of-range counters on hand-built Hlcs */
        lt[i] = (ms << 16) + counter;
        PyList_SET_ITEM(nodes, i, node);
        PyObject *v = PyObject_GetAttr(r, s_value);
        if (!v) goto done;
        PyList_SET_ITEM(values, i, v);
        if (with_modified) {
            PyObject *mod = PyObject_GetAttr(r, s_modified);
            if (!mod) goto done;
            PyObject *mms_o = PyObject_GetAttr(mod, s_millis);
            PyObject *mc_o = mms_o
                ? PyObject_GetAttr(mod, s_counter) : NULL;
            PyObject *mnode = mc_o
                ? PyObject_GetAttr(mod, s_node_id) : NULL;
            Py_DECREF(mod);
            if (!mnode) {
                Py_XDECREF(mms_o); Py_XDECREF(mc_o);
                goto done;
            }
            long long mms = PyLong_AsLongLong(mms_o);
            Py_DECREF(mms_o);
            if (mms == -1 && PyErr_Occurred()) {
                Py_DECREF(mc_o); Py_DECREF(mnode); goto done;
            }
            long long mc = PyLong_AsLongLong(mc_o);
            Py_DECREF(mc_o);
            if (mc == -1 && PyErr_Occurred()) {
                Py_DECREF(mnode); goto done;
            }
            if (mms > 0x7FFFFFFFFFFFLL || mms < -0x800000000000LL) {
                Py_DECREF(mnode);
                PyErr_SetString(PyExc_OverflowError,
                                "HLC millis outside the int64 lane "
                                "range (|millis| >= 2^47)");
                goto done;
            }
            mlt[i] = (mms << 16) + mc;
            PyList_SET_ITEM(mnodes, i, mnode);
        }
    }
    result = with_modified
        ? PyTuple_Pack(5, lt_buf, nodes, values, mlt_buf, mnodes)
        : PyTuple_Pack(3, lt_buf, nodes, values);
done:
    Py_XDECREF(lt_buf); Py_XDECREF(nodes); Py_XDECREF(values);
    Py_XDECREF(mlt_buf); Py_XDECREF(mnodes);
    return result;
}

static PyMethodDef methods[] = {
    {"parse_hlc_batch", parse_hlc_batch, METH_O,
     "Batch-parse canonical HLC wire strings."},
    {"records_to_columns", records_to_columns, METH_VARARGS,
     "Batch attribute extraction from Record objects to lanes."},
    {"format_hlc_batch", format_hlc_batch, METH_VARARGS,
     "Batch-format HLC components to wire strings."},
    {"parse_wire", parse_wire, METH_VARARGS,
     "One-pass columnar scan of a wire JSON payload."},
    {"parse_wire_dense", parse_wire_dense, METH_O,
     "Dense-model scan: int keys + int values to raw buffers."},
    {"format_wire", format_wire, METH_VARARGS,
     "Assemble a wire JSON payload from parallel columns."},
    {"dump_values", dump_values, METH_VARARGS,
     "Batch compact-JSON text for a value column."},
    {"ensure_slots", ensure_slots, METH_VARARGS,
     "Batch get-or-insert of keys into a key->slot dict."},
    {"ordinals", ordinals, METH_VARARGS,
     "Batched int32 dict lookups for node ordinals."},
    {"none_mask", none_mask, METH_O,
     "uint8 mask of None entries in a list."},
    {"scatter_payload", scatter_payload, METH_VARARGS,
     "payload[slots[w]] = values[w] for winner indices."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_hlccodec",
    "Native batch codec for HLC wire strings.", -1, methods};

PyMODINIT_FUNC PyInit__hlccodec(void) { return PyModule_Create(&module); }
