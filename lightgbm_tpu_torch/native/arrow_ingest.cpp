// Arrow C-data-interface ingestion for the native ABI.
//
// Role of the reference's nanoarrow-backed Arrow layer
// (ref: include/LightGBM/arrow.h, src/arrow/array.hpp ArrowChunkedArray
// — chunked-array iterators over the C data interface;
// c_api.h:461-480 DatasetCreateFromArrow(Stream), :596-616
// SetFieldFromArrow(Stream), :1493-1536 PredictForArrow(Stream)).
// Implementation reads the spec-defined ABI structs directly (validity
// bitmaps + primitive value buffers, all fixed-width formats) and
// materializes once into the dense buffers the existing entry points
// consume — the same single copy the reference performs when pushing
// Arrow values into its Dataset bins.
//
// Ownership: direct (chunks, schema) arguments stay caller-owned;
// stream variants consume the stream (each chunk and the schema are
// released after reading, and the stream itself on completion) per the
// C stream interface contract.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

// ---- Arrow C data/stream interface (apache spec ABI) -------------------

extern "C" {

struct ArrowSchema {
  const char* format;
  const char* name;
  const char* metadata;
  int64_t flags;
  int64_t n_children;
  struct ArrowSchema** children;
  struct ArrowSchema* dictionary;
  void (*release)(struct ArrowSchema*);
  void* private_data;
};

struct ArrowArray {
  int64_t length;
  int64_t null_count;
  int64_t offset;
  int64_t n_buffers;
  int64_t n_children;
  const void** buffers;
  struct ArrowArray** children;
  struct ArrowArray* dictionary;
  void (*release)(struct ArrowArray*);
  void* private_data;
};

struct ArrowArrayStream {
  int (*get_schema)(struct ArrowArrayStream*, struct ArrowSchema* out);
  int (*get_next)(struct ArrowArrayStream*, struct ArrowArray* out);
  const char* (*get_last_error)(struct ArrowArrayStream*);
  void (*release)(struct ArrowArrayStream*);
  void* private_data;
};

// provided by c_api.cpp / c_api_train.cpp
void LgbmTrainSetError(const char* msg);
int LGBM_DatasetCreateFromMat(const void* data, int data_type,
                              int32_t nrow, int32_t ncol,
                              int is_row_major, const char* parameters,
                              const void* reference, void** out);
int LGBM_DatasetSetField(void* handle, const char* field_name,
                         const void* field_data, int32_t num_element,
                         int data_type);
int LGBM_BoosterPredictForMat(void* handle, const void* data,
                              int data_type, int32_t nrow, int32_t ncol,
                              int is_row_major, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result);

}  // extern "C"

namespace {

bool BitSet(const uint8_t* bits, int64_t i) {
  return (bits[i >> 3] >> (i & 7)) & 1;
}

// read one primitive array's element i (post-offset) as double;
// NaN for nulls. Returns false on unsupported format.
struct ColumnReader {
  const char* fmt = nullptr;
  const uint8_t* validity = nullptr;
  const void* values = nullptr;
  int64_t offset = 0;

  bool Init(const ArrowSchema* s, const ArrowArray* a,
            std::string* err) {
    fmt = s->format ? s->format : "";
    if (a->n_buffers < 2) {
      *err = std::string("arrow column '") +
             (s->name ? s->name : "?") +
             "' is not a fixed-width primitive array";
      return false;
    }
    validity = static_cast<const uint8_t*>(a->buffers[0]);
    values = a->buffers[1];
    offset = a->offset;
    // supported: fixed-width primitives (the reference's arrow.h
    // supports the same set via ArrowChunkedArray templates)
    static const char* ok = "cCsSiIlLfgb";
    if (std::strlen(fmt) != 1 ||
        std::strchr(ok, fmt[0]) == nullptr) {
      *err = std::string("unsupported arrow format '") + fmt +
             "' for column '" + (s->name ? s->name : "?") +
             "' (fixed-width primitives only)";
      return false;
    }
    return true;
  }

  double At(int64_t i) const {
    const int64_t j = i + offset;
    if (validity && !BitSet(validity, j))
      return std::numeric_limits<double>::quiet_NaN();
    switch (fmt[0]) {
      case 'c': return static_cast<const int8_t*>(values)[j];
      case 'C': return static_cast<const uint8_t*>(values)[j];
      case 's': return static_cast<const int16_t*>(values)[j];
      case 'S': return static_cast<const uint16_t*>(values)[j];
      case 'i': return static_cast<const int32_t*>(values)[j];
      case 'I': return static_cast<const uint32_t*>(values)[j];
      case 'l': return static_cast<double>(
          static_cast<const int64_t*>(values)[j]);
      case 'L': return static_cast<double>(
          static_cast<const uint64_t*>(values)[j]);
      case 'f': return static_cast<const float*>(values)[j];
      case 'g': return static_cast<const double*>(values)[j];
      case 'b': return BitSet(static_cast<const uint8_t*>(values), j)
                       ? 1.0 : 0.0;
    }
    return std::numeric_limits<double>::quiet_NaN();
  }
};

// materialize a chunked struct-of-columns table into row-major f64
bool TableToF64(int64_t n_chunks, const ArrowArray* chunks,
                const ArrowSchema* schema, std::vector<double>* out,
                int64_t* nrow, int64_t* ncol, std::string* err) {
  if (!chunks || !schema) {
    *err = "null arrow chunks/schema";
    return false;
  }
  const int64_t F = schema->n_children;
  if (F <= 0) {
    *err = "arrow schema has no children (expected a struct table)";
    return false;
  }
  int64_t R = 0;
  for (int64_t c = 0; c < n_chunks; ++c) R += chunks[c].length;
  out->assign(static_cast<size_t>(R) * F, 0.0);
  int64_t row0 = 0;
  for (int64_t c = 0; c < n_chunks; ++c) {
    const ArrowArray& ch = chunks[c];
    if (ch.n_children != F) {
      *err = "arrow chunk child count does not match the schema";
      return false;
    }
    // a sliced struct export shifts every child by the PARENT offset
    // (Arrow columnar spec); a null parent row is a whole-NaN row
    const uint8_t* pvalid =
        ch.n_buffers >= 1 ? static_cast<const uint8_t*>(ch.buffers[0])
                          : nullptr;
    for (int64_t f = 0; f < F; ++f) {
      ColumnReader rd;
      if (!rd.Init(schema->children[f], ch.children[f], err))
        return false;
      double* dst = out->data() + row0 * F + f;
      for (int64_t i = 0; i < ch.length; ++i) {
        const bool prow_null =
            pvalid && !BitSet(pvalid, i + ch.offset);
        dst[i * F] = prow_null
                         ? std::numeric_limits<double>::quiet_NaN()
                         : rd.At(i + ch.offset);
      }
    }
    row0 += ch.length;
  }
  *nrow = R;
  *ncol = F;
  return true;
}

// single-column chunked array (SetField): schema may be the column
// itself or a 1-child struct
bool ColumnToF64(int64_t n_chunks, const ArrowArray* chunks,
                 const ArrowSchema* schema, std::vector<double>* out,
                 std::string* err) {
  const bool wrapped = schema->n_children == 1;
  const ArrowSchema* cs = wrapped ? schema->children[0] : schema;
  int64_t R = 0;
  for (int64_t c = 0; c < n_chunks; ++c) R += chunks[c].length;
  out->clear();
  out->reserve(static_cast<size_t>(R));
  for (int64_t c = 0; c < n_chunks; ++c) {
    const ArrowArray& ch = chunks[c];
    const bool is_struct = wrapped && ch.n_children == 1;
    const ArrowArray* a = is_struct ? ch.children[0] : &ch;
    ColumnReader rd;
    if (!rd.Init(cs, a, err)) return false;
    // wrapped case: the PARENT struct's length/offset/validity govern
    // the logical rows (a sliced export keeps the child unsliced)
    const int64_t poff = is_struct ? ch.offset : 0;
    const uint8_t* pvalid =
        is_struct && ch.n_buffers >= 1
            ? static_cast<const uint8_t*>(ch.buffers[0]) : nullptr;
    for (int64_t i = 0; i < ch.length; ++i) {
      const bool prow_null = pvalid && !BitSet(pvalid, i + poff);
      out->push_back(prow_null
                         ? std::numeric_limits<double>::quiet_NaN()
                         : rd.At(i + poff));
    }
  }
  return true;
}

// drain a stream into owned chunk storage (released by the caller of
// Drain via ReleaseAll)
struct StreamChunks {
  ArrowSchema schema{};
  std::vector<ArrowArray> chunks;
  bool have_schema = false;

  bool Drain(ArrowArrayStream* stream, std::string* err) {
    if (!stream || !stream->get_schema || !stream->get_next) {
      *err = "invalid arrow stream";
      return false;
    }
    if (stream->get_schema(stream, &schema) != 0) {
      const char* m = stream->get_last_error
                          ? stream->get_last_error(stream) : nullptr;
      *err = m ? m : "get_schema failed";
      return false;
    }
    have_schema = true;
    while (true) {
      ArrowArray a{};
      if (stream->get_next(stream, &a) != 0) {
        const char* m = stream->get_last_error
                            ? stream->get_last_error(stream) : nullptr;
        *err = m ? m : "get_next failed";
        return false;
      }
      if (a.release == nullptr) break;  // end of stream
      chunks.push_back(a);
    }
    return true;
  }

  ~StreamChunks() {
    for (auto& a : chunks)
      if (a.release) a.release(&a);
    if (have_schema && schema.release) schema.release(&schema);
  }
};

}  // namespace

extern "C" {

int LGBM_DatasetCreateFromArrow(int64_t n_chunks,
                                struct ArrowArray* chunks,
                                struct ArrowSchema* schema,
                                const char* parameters,
                                const void* reference, void** out) {
  std::vector<double> buf;
  int64_t R = 0, F = 0;
  std::string err;
  if (!TableToF64(n_chunks, chunks, schema, &buf, &R, &F, &err)) {
    LgbmTrainSetError(err.c_str());
    return -1;
  }
  if (R > 2147483647 || F > 2147483647) {
    LgbmTrainSetError("arrow table exceeds int32 row/column limits");
    return -1;
  }
  return LGBM_DatasetCreateFromMat(buf.data(), 1,
                                   static_cast<int32_t>(R),
                                   static_cast<int32_t>(F), 1,
                                   parameters, reference, out);
}

int LGBM_DatasetCreateFromArrowStream(struct ArrowArrayStream* stream,
                                      const char* parameters,
                                      const void* reference,
                                      void** out) {
  StreamChunks sc;
  std::string err;
  if (!sc.Drain(stream, &err)) {
    LgbmTrainSetError(err.c_str());
    if (stream && stream->release) stream->release(stream);
    return -1;
  }
  int rc = LGBM_DatasetCreateFromArrow(
      static_cast<int64_t>(sc.chunks.size()), sc.chunks.data(),
      &sc.schema, parameters, reference, out);
  if (stream->release) stream->release(stream);
  return rc;
}

int LGBM_DatasetSetFieldFromArrow(void* handle, const char* field_name,
                                  int64_t n_chunks,
                                  struct ArrowArray* chunks,
                                  struct ArrowSchema* schema) {
  std::vector<double> col;
  std::string err;
  if (!chunks || !schema ||
      !ColumnToF64(n_chunks, chunks, schema, &col, &err)) {
    LgbmTrainSetError(err.empty() ? "null arrow arguments"
                                  : err.c_str());
    return -1;
  }
  const std::string fn = field_name ? field_name : "";
  // reference dtype contract (c_api.h:603-608): group -> int32,
  // label/weight -> float32, init_score -> float64
  if (col.size() > 2147483647u) {
    LgbmTrainSetError("arrow field exceeds int32 element limits");
    return -1;
  }
  if (fn == "group" || fn == "query") {
    std::vector<int32_t> v(col.size());
    for (size_t i = 0; i < col.size(); ++i) {
      if (!std::isfinite(col[i])) {
        LgbmTrainSetError("arrow group/query field contains nulls or "
                          "non-finite values");
        return -1;
      }
      v[i] = static_cast<int32_t>(col[i]);
    }
    return LGBM_DatasetSetField(handle, field_name, v.data(),
                                static_cast<int32_t>(v.size()), 2);
  }
  if (fn == "init_score") {
    return LGBM_DatasetSetField(handle, field_name, col.data(),
                                static_cast<int32_t>(col.size()), 1);
  }
  std::vector<float> v(col.size());
  for (size_t i = 0; i < col.size(); ++i)
    v[i] = static_cast<float>(col[i]);
  return LGBM_DatasetSetField(handle, field_name, v.data(),
                              static_cast<int32_t>(v.size()), 0);
}

int LGBM_DatasetSetFieldFromArrowStream(void* handle,
                                        const char* field_name,
                                        struct ArrowArrayStream* stream) {
  StreamChunks sc;
  std::string err;
  if (!sc.Drain(stream, &err)) {
    LgbmTrainSetError(err.c_str());
    if (stream && stream->release) stream->release(stream);
    return -1;
  }
  int rc = LGBM_DatasetSetFieldFromArrow(
      handle, field_name, static_cast<int64_t>(sc.chunks.size()),
      sc.chunks.data(), &sc.schema);
  if (stream->release) stream->release(stream);
  return rc;
}

int LGBM_BoosterPredictForArrow(void* handle, int64_t n_chunks,
                                struct ArrowArray* chunks,
                                struct ArrowSchema* schema,
                                int predict_type, int start_iteration,
                                int num_iteration, const char* parameter,
                                int64_t* out_len, double* out_result) {
  std::vector<double> buf;
  int64_t R = 0, F = 0;
  std::string err;
  if (!TableToF64(n_chunks, chunks, schema, &buf, &R, &F, &err)) {
    LgbmTrainSetError(err.c_str());
    return -1;
  }
  if (R > 2147483647) {
    LgbmTrainSetError("arrow table exceeds int32 row limits");
    return -1;
  }
  return LGBM_BoosterPredictForMat(
      handle, buf.data(), 1, static_cast<int32_t>(R),
      static_cast<int32_t>(F), 1, predict_type, start_iteration,
      num_iteration, parameter, out_len, out_result);
}

int LGBM_BoosterPredictForArrowStream(void* handle,
                                      struct ArrowArrayStream* stream,
                                      int predict_type,
                                      int start_iteration,
                                      int num_iteration,
                                      const char* parameter,
                                      int64_t* out_len,
                                      double* out_result) {
  StreamChunks sc;
  std::string err;
  if (!sc.Drain(stream, &err)) {
    LgbmTrainSetError(err.c_str());
    if (stream && stream->release) stream->release(stream);
    return -1;
  }
  int rc = LGBM_BoosterPredictForArrow(
      handle, static_cast<int64_t>(sc.chunks.size()), sc.chunks.data(),
      &sc.schema, predict_type, start_iteration, num_iteration,
      parameter, out_len, out_result);
  if (stream->release) stream->release(stream);
  return rc;
}

}  // extern "C"
