// CPython extension: zero-copy batch shred entry points.
//
// The ctypes path (build.py NativeLib.proto_shred) needs the poll batch
// joined into ONE contiguous buffer (b"".join + np.fromiter lengths) before
// the decoder can run — ~35 ms per 300k records of pure copy/iteration on
// the streaming hot path (the reference's equivalent cost is zero: its
// parser reads each record's byte[] in place, KafkaProtoParquetWriter.java:
// 270).  This module reads the payload list IN PLACE instead:
// PyBytes_AS_STRING pointers feed kpw_proto_shred_iov (shred.cc) directly,
// and string columns gather straight into a freshly-allocated bytes object
// (one copy total, into the final column payload).
//
// Compiled as _kpw_torch_pyshred.so together with shred.cc (same source, no
// logic duplication); loaded via importlib ExtensionFileLoader (build.py
// pyshred()).  The GIL is released around the decode and gather loops —
// pointers stay valid because the payload list (and its bytes items) are
// owned by the calling frame for the duration.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <vector>

extern "C" {
int64_t kpw_proto_shred_iov(const uint8_t* const* ptrs, const int64_t* lens,
                            int64_t n_rec, int32_t n_fields,
                            const uint32_t* fnum, const uint8_t* kind,
                            const uint8_t* flags, void* const* out_vals,
                            int64_t* const* out_pos, int32_t* const* out_len,
                            uint8_t* const* out_pres);
void kpw_gather_spans_iov(const uint8_t* const* ptrs, const int32_t* rec_idx,
                          const int64_t* pos, const int32_t* len, int64_t n,
                          uint8_t* out);
int64_t kpw_proto_shred(const uint8_t* buf, const int64_t* offs,
                        int64_t n_rec, int32_t n_fields, const uint32_t* fnum,
                        const uint8_t* kind, const uint8_t* flags,
                        void* const* out_vals, int64_t* const* out_pos,
                        int32_t* const* out_len, uint8_t* const* out_pres);
void kpw_gather_spans(const uint8_t* src, const int64_t* pos,
                      const int32_t* len, int64_t n, uint8_t* out);
// shred_nested.cc (compiled into this .so — same source as the ctypes
// library, so the two decode paths cannot drift)
struct KpwNestedOut;
int64_t kpw_proto_shred_nested(
    const uint8_t* buf, const int64_t* offs, int64_t n_rec, int32_t n_nodes,
    int32_t n_leaves, const uint32_t* fnum, const uint8_t* kind,
    const uint8_t* flags, const int32_t* child_begin,
    const int32_t* child_end, const int32_t* leaf_idx, const int32_t* ftab,
    const int32_t* ftab_off, const int32_t* max_fn, const int32_t* enum_vals,
    const int32_t* enum_off, const int32_t* enum_len,
    const int32_t* null_leaves, const int32_t* null_off,
    const int32_t* null_len, KpwNestedOut** out);
void kpw_nested_free(KpwNestedOut* o);
int32_t kpw_nested_n_leaves(KpwNestedOut* o);
void kpw_nested_sizes(KpwNestedOut* o, int64_t* out);
int kpw_nested_fill_leaf(KpwNestedOut* o, int32_t leaf, const uint8_t* buf,
                         int64_t buf_len, void* values_out,
                         int64_t* offsets_out, uint8_t* payload_out,
                         uint32_t* defs_out, uint32_t* reps_out);
}

namespace {

// payload list -> per-record pointers/lengths, zero copy.  false = a
// non-bytes element (caller falls back to the ctypes path); TypeError set.
bool collect_iov(PyObject* payloads, std::vector<const uint8_t*>& ptrs,
                 std::vector<int64_t>& lens, int64_t* total) {
  Py_ssize_t n = PyList_GET_SIZE(payloads);
  ptrs.resize(n);
  lens.resize(n);
  int64_t t = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* it = PyList_GET_ITEM(payloads, i);
    if (!PyBytes_Check(it)) {
      PyErr_SetString(PyExc_TypeError, "payloads must all be bytes");
      return false;
    }
    ptrs[i] = reinterpret_cast<const uint8_t*>(PyBytes_AS_STRING(it));
    lens[i] = PyBytes_GET_SIZE(it);
    t += lens[i];
  }
  *total = t;
  return true;
}

struct BufferSet {
  std::vector<Py_buffer> views;
  ~BufferSet() {
    for (auto& v : views) PyBuffer_Release(&v);
  }
  // None -> nullptr; else writable buffer pointer
  bool get(PyObject* obj, void** out, int flags = PyBUF_WRITABLE) {
    if (obj == Py_None) {
      *out = nullptr;
      return true;
    }
    Py_buffer v;
    if (PyObject_GetBuffer(obj, &v, flags) != 0) return false;
    views.push_back(v);
    *out = v.buf;
    return true;
  }
  // like get, but also reports the view's byte length (0 for None) — the
  // nested_fill geometry checks need pointer AND length per output
  bool get_sized(PyObject* obj, void** out, Py_ssize_t* len_out,
                 int flags = PyBUF_WRITABLE) {
    *len_out = 0;
    if (!get(obj, out, flags)) return false;
    if (*out != nullptr) *len_out = views.back().len;
    return true;
  }
};

PyObject* py_shred_flat(PyObject*, PyObject* args) {
  PyObject *payloads, *fnum_o, *kinds_o, *flags_o;
  PyObject *vals_t, *pos_t, *len_t, *pres_t;
  if (!PyArg_ParseTuple(args, "O!OOOO!O!O!O!", &PyList_Type, &payloads,
                        &fnum_o, &kinds_o, &flags_o, &PyTuple_Type, &vals_t,
                        &PyTuple_Type, &pos_t, &PyTuple_Type, &len_t,
                        &PyTuple_Type, &pres_t))
    return nullptr;
  std::vector<const uint8_t*> ptrs;
  std::vector<int64_t> lens;
  int64_t total;
  if (!collect_iov(payloads, ptrs, lens, &total)) return nullptr;

  BufferSet bufs;
  void *fnum_p, *kinds_p, *flags_p;
  if (!bufs.get(fnum_o, &fnum_p, PyBUF_SIMPLE) ||
      !bufs.get(kinds_o, &kinds_p, PyBUF_SIMPLE) ||
      !bufs.get(flags_o, &flags_p, PyBUF_SIMPLE))
    return nullptr;
  Py_ssize_t nf = PyTuple_GET_SIZE(vals_t);
  if (PyTuple_GET_SIZE(pos_t) != nf || PyTuple_GET_SIZE(len_t) != nf ||
      PyTuple_GET_SIZE(pres_t) != nf) {
    PyErr_SetString(PyExc_ValueError, "output tuples must align");
    return nullptr;
  }
  std::vector<void*> vals(nf);
  std::vector<int64_t*> pos(nf);
  std::vector<int32_t*> lenp(nf);
  std::vector<uint8_t*> pres(nf);
  for (Py_ssize_t f = 0; f < nf; f++) {
    void *a, *b, *c, *d;
    if (!bufs.get(PyTuple_GET_ITEM(vals_t, f), &a) ||
        !bufs.get(PyTuple_GET_ITEM(pos_t, f), &b) ||
        !bufs.get(PyTuple_GET_ITEM(len_t, f), &c) ||
        !bufs.get(PyTuple_GET_ITEM(pres_t, f), &d))
      return nullptr;
    vals[f] = a;
    pos[f] = static_cast<int64_t*>(b);
    lenp[f] = static_cast<int32_t*>(c);
    pres[f] = static_cast<uint8_t*>(d);
  }
  int64_t rc;
  Py_BEGIN_ALLOW_THREADS
  rc = kpw_proto_shred_iov(ptrs.data(), lens.data(), ptrs.size(),
                           int32_t(nf),
                           static_cast<const uint32_t*>(fnum_p),
                           static_cast<const uint8_t*>(kinds_p),
                           static_cast<const uint8_t*>(flags_p),
                           vals.data(), pos.data(), lenp.data(),
                           pres.data());
  Py_END_ALLOW_THREADS
  return Py_BuildValue("LL", static_cast<long long>(rc),
                       static_cast<long long>(total));
}

// gather_iov(payloads, rec_idx i32 buffer, pos i64 buffer, len i32 buffer)
// -> bytes (the concatenated span payload, allocated here so ByteColumn
// gets a real bytes object with exactly one copy)
PyObject* py_gather_iov(PyObject*, PyObject* args) {
  PyObject *payloads, *idx_o, *pos_o, *len_o;
  if (!PyArg_ParseTuple(args, "O!OOO", &PyList_Type, &payloads, &idx_o,
                        &pos_o, &len_o))
    return nullptr;
  std::vector<const uint8_t*> ptrs;
  std::vector<int64_t> lens;
  int64_t total_payload;
  if (!collect_iov(payloads, ptrs, lens, &total_payload)) return nullptr;
  // idx/pos/len are mandatory here (BufferSet maps None to nullptr for the
  // shred entry points' optional outputs; a None in THIS call would shift
  // views[] and size the span count from the wrong buffer — over-read)
  if (idx_o == Py_None || pos_o == Py_None || len_o == Py_None) {
    PyErr_SetString(PyExc_TypeError,
                    "gather_iov: rec_idx/pos/len buffers must not be None");
    return nullptr;
  }
  BufferSet bufs;
  void *idx_p, *pos_p, *len_p;
  if (!bufs.get(idx_o, &idx_p, PyBUF_SIMPLE) ||
      !bufs.get(pos_o, &pos_p, PyBUF_SIMPLE) ||
      !bufs.get(len_o, &len_p, PyBUF_SIMPLE))
    return nullptr;
  // span count from the len buffer's OWN view (views[2]), not positional
  // assumption on views[0]
  Py_ssize_t n = bufs.views[2].len / sizeof(int32_t);
  const int32_t* ln = static_cast<const int32_t*>(len_p);
  int64_t out_len = 0;
  for (Py_ssize_t i = 0; i < n; i++) out_len += ln[i];
  PyObject* out = PyBytes_FromStringAndSize(nullptr, out_len);
  if (out == nullptr) return nullptr;
  uint8_t* dst = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  Py_BEGIN_ALLOW_THREADS
  kpw_gather_spans_iov(ptrs.data(), static_cast<const int32_t*>(idx_p),
                       static_cast<const int64_t*>(pos_p), ln, n, dst);
  Py_END_ALLOW_THREADS
  return out;
}

// shred_flat_buf(buf, offs i64 buffer (n_rec+1, ascending; offs[0] may be
// nonzero — a RecordBatch slice window), fnum, kinds, flags, vals_t,
// pos_t, len_t, pres_t) -> (rc, total).  The batch-native ingest entry:
// one contiguous fetch buffer goes to the decoder AS-IS (no per-record
// bytes objects, no join), GIL released around the decode like
// shred_flat — the ctypes route's Python-side marshalling per call was
// measurable GIL pressure against the encode pipeline thread.
PyObject* py_shred_flat_buf(PyObject*, PyObject* args) {
  PyObject *buf_o, *offs_o, *fnum_o, *kinds_o, *flags_o;
  PyObject *vals_t, *pos_t, *len_t, *pres_t;
  if (!PyArg_ParseTuple(args, "OOOOOO!O!O!O!", &buf_o, &offs_o, &fnum_o,
                        &kinds_o, &flags_o, &PyTuple_Type, &vals_t,
                        &PyTuple_Type, &pos_t, &PyTuple_Type, &len_t,
                        &PyTuple_Type, &pres_t))
    return nullptr;
  BufferSet bufs;
  void *buf_p, *offs_p, *fnum_p, *kinds_p, *flags_p;
  if (!bufs.get(buf_o, &buf_p, PyBUF_SIMPLE) ||
      !bufs.get(offs_o, &offs_p, PyBUF_SIMPLE) ||
      !bufs.get(fnum_o, &fnum_p, PyBUF_SIMPLE) ||
      !bufs.get(kinds_o, &kinds_p, PyBUF_SIMPLE) ||
      !bufs.get(flags_o, &flags_p, PyBUF_SIMPLE))
    return nullptr;
  // record count from the offsets buffer's own view (len n_rec + 1)
  Py_ssize_t n_rec = bufs.views[1].len / Py_ssize_t(sizeof(int64_t)) - 1;
  if (n_rec < 0) {
    PyErr_SetString(PyExc_ValueError, "offs must hold >= 1 int64");
    return nullptr;
  }
  const int64_t* offs = static_cast<const int64_t*>(offs_p);
  if (n_rec > 0 && (offs[0] < 0 ||
                    offs[n_rec] > int64_t(bufs.views[0].len))) {
    PyErr_SetString(PyExc_ValueError, "offs out of buffer bounds");
    return nullptr;
  }
  // full ascending walk, not just the end points: one malformed interior
  // offset would otherwise send the decoder out of buffer bounds
  for (Py_ssize_t i = 0; i < n_rec; i++) {
    if (offs[i + 1] < offs[i]) {
      PyErr_SetString(PyExc_ValueError, "offs must be ascending");
      return nullptr;
    }
  }
  Py_ssize_t nf = PyTuple_GET_SIZE(vals_t);
  if (PyTuple_GET_SIZE(pos_t) != nf || PyTuple_GET_SIZE(len_t) != nf ||
      PyTuple_GET_SIZE(pres_t) != nf) {
    PyErr_SetString(PyExc_ValueError, "output tuples must align");
    return nullptr;
  }
  std::vector<void*> vals(nf);
  std::vector<int64_t*> pos(nf);
  std::vector<int32_t*> lenp(nf);
  std::vector<uint8_t*> pres(nf);
  for (Py_ssize_t f = 0; f < nf; f++) {
    void *a, *b, *c, *d;
    if (!bufs.get(PyTuple_GET_ITEM(vals_t, f), &a) ||
        !bufs.get(PyTuple_GET_ITEM(pos_t, f), &b) ||
        !bufs.get(PyTuple_GET_ITEM(len_t, f), &c) ||
        !bufs.get(PyTuple_GET_ITEM(pres_t, f), &d))
      return nullptr;
    vals[f] = a;
    pos[f] = static_cast<int64_t*>(b);
    lenp[f] = static_cast<int32_t*>(c);
    pres[f] = static_cast<uint8_t*>(d);
  }
  int64_t total = n_rec > 0 ? offs[n_rec] - offs[0] : 0;
  int64_t rc;
  Py_BEGIN_ALLOW_THREADS
  rc = kpw_proto_shred(static_cast<const uint8_t*>(buf_p), offs, n_rec,
                       int32_t(nf), static_cast<const uint32_t*>(fnum_p),
                       static_cast<const uint8_t*>(kinds_p),
                       static_cast<const uint8_t*>(flags_p), vals.data(),
                       pos.data(), lenp.data(), pres.data());
  Py_END_ALLOW_THREADS
  return Py_BuildValue("LL", static_cast<long long>(rc),
                       static_cast<long long>(total));
}

// gather_buf(buf, pos i64 buffer, len i32 buffer) -> bytes: span
// concatenation out of ONE contiguous buffer (absolute positions, the
// shred_flat_buf counterpart of gather_iov), GIL released around the copy.
PyObject* py_gather_buf(PyObject*, PyObject* args) {
  PyObject *buf_o, *pos_o, *len_o;
  if (!PyArg_ParseTuple(args, "OOO", &buf_o, &pos_o, &len_o)) return nullptr;
  if (pos_o == Py_None || len_o == Py_None) {
    PyErr_SetString(PyExc_TypeError,
                    "gather_buf: pos/len buffers must not be None");
    return nullptr;
  }
  BufferSet bufs;
  void *buf_p, *pos_p, *len_p;
  if (!bufs.get(buf_o, &buf_p, PyBUF_SIMPLE) ||
      !bufs.get(pos_o, &pos_p, PyBUF_SIMPLE) ||
      !bufs.get(len_o, &len_p, PyBUF_SIMPLE))
    return nullptr;
  Py_ssize_t n = bufs.views[2].len / Py_ssize_t(sizeof(int32_t));
  const int32_t* ln = static_cast<const int32_t*>(len_p);
  int64_t out_len = 0;
  for (Py_ssize_t i = 0; i < n; i++) out_len += ln[i];
  PyObject* out = PyBytes_FromStringAndSize(nullptr, out_len);
  if (out == nullptr) return nullptr;
  uint8_t* dst = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  Py_BEGIN_ALLOW_THREADS
  kpw_gather_spans(static_cast<const uint8_t*>(buf_p),
                   static_cast<const int64_t*>(pos_p), ln, n, dst);
  Py_END_ALLOW_THREADS
  return out;
}

// -- fused nested shred ------------------------------------------------------
//
// The ctypes nested route (build.py NestedShredResult) pays 5 ctypes
// round trips per leaf with the GIL held, copies every output twice
// (C arena -> ctypes view -> numpy .copy()), widens levels u8->i32 in
// numpy, and gathers string payloads through create_string_buffer (a
// third copy).  These two entries replace all of it with TWO C calls
// per batch: decode (GIL released) returning an opaque handle plus the
// per-leaf geometry table, then one fill call (GIL released) that
// materializes every leaf straight into its FINAL representation —
// fixed values into numpy arrays, span payloads into freshly-allocated
// bytes objects with their int64 ByteColumn offset tables, def/rep
// levels widened to the uint32 the nogil page assembler's RLE ops
// consume.  One copy per output, zero per-leaf Python work.
//
// Contract: the PLAN buffers are trusted (built by proto_bridge
// _NestedPlan from the schema — same trust the ctypes route extends);
// the WIRE buffer and offset table are hostile and fully validated
// (ascending walk, bounds) before the decoder runs, and every span is
// re-checked against the buffer handed to nested_fill.

void nested_capsule_free(PyObject* cap) {
  auto* o = static_cast<KpwNestedOut*>(
      PyCapsule_GetPointer(cap, "kpw_nested_out"));
  if (o != nullptr) kpw_nested_free(o);
}

// shred_nested_buf(buf, offs, n_nodes, n_leaves, fnum, kind, flags,
//                  tabs: tuple of 12 int32 buffers)
//   -> (rc, capsule | None, sizes bytes | None)
// rc = -1 on success; else the first record index needing the Python
// fallback.  sizes = int64[n_leaves, 4]:
//   [value_bytes, n_spans, span_payload_bytes, n_levels] per leaf.
PyObject* py_shred_nested_buf(PyObject*, PyObject* args) {
  PyObject *buf_o, *offs_o, *fnum_o, *kind_o, *flags_o, *tabs_t;
  int n_nodes, n_leaves;
  if (!PyArg_ParseTuple(args, "OOiiOOOO!", &buf_o, &offs_o, &n_nodes,
                        &n_leaves, &fnum_o, &kind_o, &flags_o, &PyTuple_Type,
                        &tabs_t))
    return nullptr;
  if (n_nodes <= 0 || n_leaves <= 0) {
    PyErr_SetString(PyExc_ValueError, "n_nodes/n_leaves must be positive");
    return nullptr;
  }
  if (PyTuple_GET_SIZE(tabs_t) != 12) {
    PyErr_SetString(PyExc_ValueError, "plan tabs tuple must have 12 buffers");
    return nullptr;
  }
  BufferSet bufs;
  void *buf_p, *offs_p, *fnum_p, *kind_p, *flags_p;
  if (!bufs.get(buf_o, &buf_p, PyBUF_SIMPLE) ||
      !bufs.get(offs_o, &offs_p, PyBUF_SIMPLE) ||
      !bufs.get(fnum_o, &fnum_p, PyBUF_SIMPLE) ||
      !bufs.get(kind_o, &kind_p, PyBUF_SIMPLE) ||
      !bufs.get(flags_o, &flags_p, PyBUF_SIMPLE))
    return nullptr;
  // hostile-input validation, exactly shred_flat_buf's discipline
  Py_ssize_t n_rec = bufs.views[1].len / Py_ssize_t(sizeof(int64_t)) - 1;
  if (n_rec < 0) {
    PyErr_SetString(PyExc_ValueError, "offs must hold >= 1 int64");
    return nullptr;
  }
  const int64_t* offs = static_cast<const int64_t*>(offs_p);
  if (n_rec > 0 && (offs[0] < 0 ||
                    offs[n_rec] > int64_t(bufs.views[0].len))) {
    PyErr_SetString(PyExc_ValueError, "offs out of buffer bounds");
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n_rec; i++) {
    if (offs[i + 1] < offs[i]) {
      PyErr_SetString(PyExc_ValueError, "offs must be ascending");
      return nullptr;
    }
  }
  // plan-shape sanity: node-indexed tables must cover n_nodes entries
  // (content is trusted; a SHORT buffer would still be an OOB read)
  if (bufs.views[2].len < Py_ssize_t(n_nodes) * 4 ||
      bufs.views[3].len < n_nodes || bufs.views[4].len < n_nodes) {
    PyErr_SetString(PyExc_ValueError, "plan fnum/kind/flags too short");
    return nullptr;
  }
  const int32_t* tabs[12];
  // per-node int32 tables (every one indexed by node id except ftab /
  // enum_vals / null_leaves, whose minimum is 1 element)
  static const bool per_node[12] = {true, true, true, false, true, true,
                                    false, true, true, false, true, true};
  for (int t = 0; t < 12; t++) {
    void* p;
    if (!bufs.get(PyTuple_GET_ITEM(tabs_t, t), &p, PyBUF_SIMPLE))
      return nullptr;
    const Py_buffer& v = bufs.views[bufs.views.size() - 1];
    const Py_ssize_t need = (per_node[t] ? Py_ssize_t(n_nodes) : 1) * 4;
    if (v.len < need) {
      PyErr_SetString(PyExc_ValueError, "plan table too short");
      return nullptr;
    }
    tabs[t] = static_cast<const int32_t*>(p);
  }
  KpwNestedOut* out = nullptr;
  int64_t rc;
  Py_BEGIN_ALLOW_THREADS
  rc = kpw_proto_shred_nested(
      static_cast<const uint8_t*>(buf_p), offs, n_rec, n_nodes, n_leaves,
      static_cast<const uint32_t*>(fnum_p),
      static_cast<const uint8_t*>(kind_p),
      static_cast<const uint8_t*>(flags_p), tabs[0], tabs[1], tabs[2],
      tabs[3], tabs[4], tabs[5], tabs[6], tabs[7], tabs[8], tabs[9],
      tabs[10], tabs[11], &out);
  Py_END_ALLOW_THREADS
  if (rc >= 0)
    return Py_BuildValue("LOO", static_cast<long long>(rc), Py_None,
                         Py_None);
  PyObject* sizes = PyBytes_FromStringAndSize(
      nullptr, Py_ssize_t(n_leaves) * 4 * sizeof(int64_t));
  if (sizes == nullptr) {
    kpw_nested_free(out);
    return nullptr;
  }
  kpw_nested_sizes(out,
                   reinterpret_cast<int64_t*>(PyBytes_AS_STRING(sizes)));
  PyObject* cap = PyCapsule_New(out, "kpw_nested_out", nested_capsule_free);
  if (cap == nullptr) {
    Py_DECREF(sizes);
    kpw_nested_free(out);
    return nullptr;
  }
  PyObject* res = Py_BuildValue("LNN", -1LL, cap, sizes);
  return res;
}

// nested_fill(capsule, buf, values_t, offsets_t, defs_t, reps_t)
//   -> tuple of span payload bytes (None for non-span leaves)
// Per leaf: values_t = writable fixed-width array or None (must be None
// for span leaves — their payload is allocated HERE as bytes);
// offsets_t = writable int64 (n_spans + 1) array for span leaves, None
// otherwise; defs_t / reps_t = writable uint32 arrays or None.  All
// output geometry is validated against the decode's size table before
// the GIL is released.
PyObject* py_nested_fill(PyObject*, PyObject* args) {
  PyObject *cap, *buf_o, *vals_t, *offsets_t, *defs_t, *reps_t;
  if (!PyArg_ParseTuple(args, "OOO!O!O!O!", &cap, &buf_o, &PyTuple_Type,
                        &vals_t, &PyTuple_Type, &offsets_t, &PyTuple_Type,
                        &defs_t, &PyTuple_Type, &reps_t))
    return nullptr;
  auto* o = static_cast<KpwNestedOut*>(
      PyCapsule_GetPointer(cap, "kpw_nested_out"));
  if (o == nullptr) return nullptr;  // wrong/expired capsule: TypeError set
  const Py_ssize_t nl = PyTuple_GET_SIZE(vals_t);
  if (PyTuple_GET_SIZE(offsets_t) != nl || PyTuple_GET_SIZE(defs_t) != nl ||
      PyTuple_GET_SIZE(reps_t) != nl) {
    PyErr_SetString(PyExc_ValueError, "output tuples must align");
    return nullptr;
  }
  if (Py_ssize_t(kpw_nested_n_leaves(o)) != nl) {
    PyErr_SetString(PyExc_ValueError,
                    "output tuples do not match the handle's leaf count");
    return nullptr;
  }
  std::vector<int64_t> sizes(size_t(nl) * 4);
  kpw_nested_sizes(o, sizes.data());

  BufferSet bufs;
  void* buf_p;
  if (!bufs.get(buf_o, &buf_p, PyBUF_SIMPLE)) return nullptr;
  const int64_t buf_len = int64_t(bufs.views[0].len);

  std::vector<void*> vals(nl, nullptr);
  std::vector<int64_t*> offsets(nl, nullptr);
  std::vector<uint8_t*> payloads(nl, nullptr);
  std::vector<uint32_t*> defs(nl, nullptr);
  std::vector<uint32_t*> reps(nl, nullptr);
  PyObject* payload_objs = PyTuple_New(nl);
  if (payload_objs == nullptr) return nullptr;
  bool bad = false;
  const char* bad_msg = nullptr;
  for (Py_ssize_t f = 0; f < nl && !bad; f++) {
    const int64_t value_bytes = sizes[4 * f + 0];
    const int64_t n_spans = sizes[4 * f + 1];
    const int64_t payload_bytes = sizes[4 * f + 2];
    const int64_t n_levels = sizes[4 * f + 3];
    PyObject* off_o = PyTuple_GET_ITEM(offsets_t, f);
    const bool is_span = off_o != Py_None;
    void *vp, *op, *dp, *rp;
    Py_ssize_t vlen, olen, dlen, rlen;
    if (!bufs.get_sized(PyTuple_GET_ITEM(vals_t, f), &vp, &vlen) ||
        !bufs.get_sized(off_o, &op, &olen) ||
        !bufs.get_sized(PyTuple_GET_ITEM(defs_t, f), &dp, &dlen) ||
        !bufs.get_sized(PyTuple_GET_ITEM(reps_t, f), &rp, &rlen)) {
      Py_DECREF(payload_objs);
      return nullptr;
    }
    // geometry checks against the decode's own size table: a wrong
    // allocation must raise here, never write out of bounds nogil
    if (is_span) {
      if (vp != nullptr) {
        bad = true;
        bad_msg = "span leaves take no values buffer (payload is "
                  "allocated by nested_fill)";
        break;
      }
      if (olen != (n_spans + 1) * Py_ssize_t(sizeof(int64_t))) {
        bad = true;
        bad_msg = "offsets buffer length mismatch";
        break;
      }
      PyObject* pb = PyBytes_FromStringAndSize(nullptr,
                                               Py_ssize_t(payload_bytes));
      if (pb == nullptr) {
        Py_DECREF(payload_objs);
        return nullptr;
      }
      payloads[f] = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(pb));
      PyTuple_SET_ITEM(payload_objs, f, pb);
    } else {
      if (op != nullptr) {
        bad = true;
        bad_msg = "offsets buffer on a non-span leaf";
        break;
      }
      if (vp == nullptr ? value_bytes != 0
                        : vlen != Py_ssize_t(value_bytes)) {
        bad = true;
        bad_msg = "values buffer length mismatch";
        break;
      }
      Py_INCREF(Py_None);
      PyTuple_SET_ITEM(payload_objs, f, Py_None);
    }
    const Py_ssize_t lvl_len = n_levels * Py_ssize_t(sizeof(uint32_t));
    if ((dp != nullptr && dlen != lvl_len) ||
        (rp != nullptr && rlen != lvl_len)) {
      bad = true;
      bad_msg = "level buffer length mismatch";
      break;
    }
    vals[f] = vp;
    offsets[f] = static_cast<int64_t*>(op);
    defs[f] = static_cast<uint32_t*>(dp);
    reps[f] = static_cast<uint32_t*>(rp);
  }
  if (bad) {
    Py_DECREF(payload_objs);
    PyErr_SetString(PyExc_ValueError, bad_msg);
    return nullptr;
  }
  int rc = 0;
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t f = 0; f < nl && rc == 0; f++)
    rc = kpw_nested_fill_leaf(o, int32_t(f),
                              static_cast<const uint8_t*>(buf_p), buf_len,
                              vals[f], offsets[f], payloads[f], defs[f],
                              reps[f]);
  Py_END_ALLOW_THREADS
  if (rc != 0) {
    Py_DECREF(payload_objs);
    PyErr_SetString(PyExc_ValueError,
                    "span out of payload-buffer bounds (buffer does not "
                    "match the decoded batch)");
    return nullptr;
  }
  return payload_objs;
}

PyMethodDef methods[] = {
    {"shred_flat", py_shred_flat, METH_VARARGS,
     "Zero-copy flat wire shred over a list of payload bytes."},
    {"gather_iov", py_gather_iov, METH_VARARGS,
     "Concatenate spans (rec_idx, pos, len) from payload bytes -> bytes."},
    {"shred_flat_buf", py_shred_flat_buf, METH_VARARGS,
     "Flat wire shred over one contiguous buffer + record offsets."},
    {"gather_buf", py_gather_buf, METH_VARARGS,
     "Concatenate spans (pos, len) from one contiguous buffer -> bytes."},
    {"shred_nested_buf", py_shred_nested_buf, METH_VARARGS,
     "Nested wire shred over one contiguous buffer + record offsets, "
     "GIL released; returns (rc, handle, per-leaf size table)."},
    {"nested_fill", py_nested_fill, METH_VARARGS,
     "Materialize every leaf of a shred_nested_buf handle into final "
     "arrays/ByteColumn payloads in one GIL-released pass."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_kpw_torch_pyshred",
                         "zero-copy wire shred entry points", -1, methods,
                         nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__kpw_torch_pyshred(void) {
  return PyModule_Create(&moduledef);
}
