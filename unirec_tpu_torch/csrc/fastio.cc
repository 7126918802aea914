// Native table parser for the text formats the framework reads (TSV/CSV
// with list-valued columns); the port's copy of unirec_tpu/native/fastio.cc,
// built by unirec_tpu_torch/utils/fastio.py with g++.
//
// A pandas read with a per-cell Python list parse crosses the Python
// boundary for every cell. This parser walks the raw bytes once to count
// rows/list elements, then fills caller-allocated packed arrays
// (flat values + per-row lengths for list columns; double scalars with an
// "all integral" flag for scalar columns) in a second pass. The Python
// side (unirec_tpu_torch/utils/fastio.py) reassembles the exact DataFrame
// the pandas path produces and declines (the caller then reads with
// pandas) anything this parser does not recognise (bracket lists, quoted
// strings, missing cells).
//
// Column type codes: 0 = scalar (parsed as double, integral-flag
// reported), 1 = int64 list, 2 = float32 list. List separator matches the
// Python semantics: ',' if the cell contains one, else ' '.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Cursor {
  const char* p;
  const char* end;
};

inline bool is_list_sep(char c, char sep) { return c == sep; }

// Parse one double; returns chars consumed (0 on failure).
inline int64_t parse_double(const char* p, const char* end, double* out,
                            bool* integral) {
  const char* s = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  bool any = false;
  double v = 0.0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10.0 + (*p - '0');
    ++p; any = true;
  }
  bool is_int = true;
  if (p < end && *p == '.') {
    is_int = false;
    ++p;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      v += (*p - '0') * scale;
      scale *= 0.1;
      ++p; any = true;
    }
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    is_int = false;
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) { eneg = (*p == '-'); ++p; }
    int64_t ev = 0;
    bool eany = false;
    while (p < end && *p >= '0' && *p <= '9') {
      ev = ev * 10 + (*p - '0');
      ++p; eany = true;
    }
    if (!eany) return 0;
    double mult = 1.0;
    for (int64_t i = 0; i < ev; ++i) mult *= 10.0;
    v = eneg ? v / mult : v * mult;
  }
  if (!any) return 0;
  *out = neg ? -v : v;
  if (integral) *integral = is_int;
  return p - s;
}

}  // namespace

extern "C" {

// Pass 1: count rows and per-list-column total elements.
// buf/len: file contents AFTER the header line. field_sep: '\t' or ','.
// n_cols: number of columns. col_types: per-column type code.
// out_rows: row count. out_list_counts[n_cols]: total list elements per
// column (0 for scalar columns).
// Returns 0 on success, negative on malformed input (caller falls back).
int64_t unirec_count(const char* buf, int64_t len, char field_sep,
                     int64_t n_cols, const int32_t* col_types,
                     int64_t* out_rows, int64_t* out_list_counts) {
  for (int64_t c = 0; c < n_cols; ++c) out_list_counts[c] = 0;
  int64_t rows = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    // skip blank trailing line
    if (*p == '\n') { ++p; continue; }
    if (*p == '\r') { ++p; continue; }
    for (int64_t c = 0; c < n_cols; ++c) {
      // cell spans until field_sep (or line end for the last column)
      const char* cell = p;
      while (p < end && *p != field_sep && *p != '\n' && *p != '\r') ++p;
      const char* cell_end = p;
      if (col_types[c] != 0) {
        if (cell == cell_end) {
          // empty list cell -> 0 elements
        } else {
          char lsep = ' ';
          for (const char* q = cell; q < cell_end; ++q)
            if (*q == ',') { lsep = ','; break; }
          int64_t n = 1;
          for (const char* q = cell; q < cell_end; ++q)
            if (is_list_sep(*q, lsep)) ++n;
          out_list_counts[c] += n;
        }
      } else {
        if (cell == cell_end) return -2;  // missing scalar -> fallback
        for (const char* q = cell; q < cell_end; ++q) {
          char ch = *q;
          if (!((ch >= '0' && ch <= '9') || ch == '-' || ch == '+' ||
                ch == '.' || ch == 'e' || ch == 'E'))
            return -3;  // non-numeric scalar (string column) -> fallback
        }
      }
      if (c + 1 < n_cols) {
        if (p >= end || *p != field_sep) return -4;  // short row
        ++p;
      }
    }
    // consume line end
    while (p < end && (*p == '\r')) ++p;
    if (p < end) {
      if (*p != '\n') return -5;  // extra columns
      ++p;
    }
    ++rows;
  }
  *out_rows = rows;
  return 0;
}

// Pass 2: fill caller-allocated buffers.
// scalars[n_cols]: double* (capacity rows) or null for list columns.
// integral[n_cols]: per-column flag set to 0 if any non-integral value.
// list_i64 / list_f32: per-column flat value buffers (null when unused).
// list_lens[n_cols]: int32* per-row lengths for list columns.
int64_t unirec_fill(const char* buf, int64_t len, char field_sep,
                    int64_t n_cols, const int32_t* col_types,
                    double** scalars, int32_t* integral,
                    int64_t** list_i64, float** list_f32,
                    int32_t** list_lens) {
  for (int64_t c = 0; c < n_cols; ++c) integral[c] = 1;
  int64_t row = 0;
  // per-column running offsets into the flat list buffers
  int64_t* offs = static_cast<int64_t*>(calloc(n_cols, sizeof(int64_t)));
  if (!offs) return -1;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    if (*p == '\n' || *p == '\r') { ++p; continue; }
    for (int64_t c = 0; c < n_cols; ++c) {
      const char* cell = p;
      while (p < end && *p != field_sep && *p != '\n' && *p != '\r') ++p;
      const char* cell_end = p;
      int32_t ty = col_types[c];
      if (ty == 0) {
        double v; bool isint;
        int64_t used = parse_double(cell, cell_end, &v, &isint);
        if (used != cell_end - cell) { free(offs); return -6; }
        scalars[c][row] = v;
        if (!isint) integral[c] = 0;
      } else {
        int32_t n = 0;
        if (cell < cell_end) {
          char lsep = ' ';
          for (const char* q = cell; q < cell_end; ++q)
            if (*q == ',') { lsep = ','; break; }
          const char* q = cell;
          while (q < cell_end) {
            double v;
            int64_t used = parse_double(q, cell_end, &v, nullptr);
            if (!used) { free(offs); return -7; }
            q += used;
            if (ty == 1) list_i64[c][offs[c]] = static_cast<int64_t>(v);
            else list_f32[c][offs[c]] = static_cast<float>(v);
            ++offs[c];
            ++n;
            if (q < cell_end) {
              if (*q != lsep) { free(offs); return -8; }
              ++q;
            }
          }
        }
        list_lens[c][row] = n;
      }
      if (c + 1 < n_cols) ++p;  // skip field sep (validated in pass 1)
    }
    while (p < end && *p == '\r') ++p;
    if (p < end) ++p;  // '\n'
    ++row;
  }
  free(offs);
  return 0;
}

}  // extern "C"
