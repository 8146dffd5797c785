// The native episode core of the host-streamed path: a multithreaded gather
// of episode image rows from a split into contiguous batches, the same gather
// of label rows, and background compositing of a ShapeNet3D split.
//
// The same functions as wmfml_tpu/_native/episode_core.cpp, with one
// change to the contract: the view permutation may have any number of
// columns (perm_cols), so a caller can hand it the views of an episode
// already padded to max_ctx and gather the padded batch in one pass. Every
// view index is checked against the split's views.
//
// Layout contract (row-major):
//   data  [n_items, views, row_bytes]   -- one "row" = one image (any dtype)
//   items [tasks]                       -- item index per task
//   perm  [tasks, perm_cols]            -- view indices per task
//   ctx   [tasks, shot,  row_bytes]     -- views perm[:, 0 : shot]
//   qry   [tasks, query, row_bytes]     -- views perm[:, shot + query_offset :
//                                          ... + query]; query_offset < 0
//                                          means from perm[:, 0] (eval mode)
//
// Built at first use by wmfml_tpu_torch/data/episode_core.py with the host
// compiler (no dependencies) and loaded through ctypes. Return codes: 0 ok,
// 1 the query views run past perm_cols, 2 an item or view index out of range.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Runs fn(i0, i1) over [0, n) in n_threads contiguous chunks (fewer when n
// is small), on the calling thread when one chunk does.
template <typename Fn>
void parallel_chunks(int64_t n, int n_threads, Fn fn) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = static_cast<int>(n);
  if (n_threads <= 1) {
    fn(int64_t{0}, n);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    const int64_t i0 = i * chunk;
    const int64_t i1 = i0 + chunk < n ? i0 + chunk : n;
    if (i0 >= i1) break;
    threads.emplace_back(fn, i0, i1);
  }
  for (auto& th : threads) th.join();
}

// 0 when every item and every view the episode reads is in range.
int check_indices(int64_t n_items, int64_t views, const int64_t* items,
                  const int64_t* perm, int64_t perm_cols, int64_t tasks,
                  int64_t shot, int64_t query, int64_t query_offset) {
  const int64_t off = query_offset >= 0 ? shot + query_offset : 0;
  if (shot > perm_cols || off + query > perm_cols) return 1;
  for (int64_t t = 0; t < tasks; ++t) {
    if (items[t] < 0 || items[t] >= n_items) return 2;
    const int64_t* p = perm + t * perm_cols;
    for (int64_t s = 0; s < shot; ++s)
      if (p[s] < 0 || p[s] >= views) return 2;
    for (int64_t q = 0; q < query; ++q)
      if (p[off + q] < 0 || p[off + q] >= views) return 2;
  }
  return 0;
}

// Copies task t's context rows, then its query rows (row elements of T
// each).
template <typename T>
void gather_task(const T* data, int64_t views, int64_t row, const int64_t* items,
                 const int64_t* perm, int64_t perm_cols, int64_t t, int64_t shot,
                 int64_t query, int64_t query_offset, T* ctx_out, T* qry_out) {
  const T* base = data + items[t] * views * row;
  const int64_t* p = perm + t * perm_cols;
  for (int64_t s = 0; s < shot; ++s)
    std::memcpy(ctx_out + (t * shot + s) * row, base + p[s] * row,
                sizeof(T) * static_cast<size_t>(row));
  const int64_t off = query_offset >= 0 ? shot + query_offset : 0;
  for (int64_t q = 0; q < query; ++q)
    std::memcpy(qry_out + (t * query + q) * row, base + p[off + q] * row,
                sizeof(T) * static_cast<size_t>(row));
}

}  // namespace

extern "C" {

// Gather context and query image rows for a batch of episodic tasks, the
// tasks split over n_threads threads.
int assemble_episode(const uint8_t* data, int64_t n_items, int64_t views,
                     int64_t row_bytes, const int64_t* items,
                     const int64_t* perm, int64_t perm_cols, int64_t tasks,
                     int64_t shot, int64_t query, int64_t query_offset,
                     uint8_t* ctx_out, uint8_t* qry_out, int n_threads) {
  const int rc = check_indices(n_items, views, items, perm, perm_cols, tasks,
                               shot, query, query_offset);
  if (rc != 0) return rc;
  parallel_chunks(tasks, n_threads, [&](int64_t t0, int64_t t1) {
    for (int64_t t = t0; t < t1; ++t)
      gather_task(data, views, row_bytes, items, perm, perm_cols, t, shot,
                  query, query_offset, ctx_out, qry_out);
  });
  return 0;
}

// The same gather of label rows (float32, dim a row), on the calling thread.
int assemble_labels(const float* labels, int64_t n_items, int64_t views,
                    int64_t dim, const int64_t* items, const int64_t* perm,
                    int64_t perm_cols, int64_t tasks, int64_t shot,
                    int64_t query, int64_t query_offset, float* ctx_out,
                    float* qry_out) {
  const int rc = check_indices(n_items, views, items, perm, perm_cols, tasks,
                               shot, query, query_offset);
  if (rc != 0) return rc;
  for (int64_t t = 0; t < tasks; ++t)
    gather_task(labels, views, dim, items, perm, perm_cols, t, shot, query,
                query_offset, ctx_out, qry_out);
  return 0;
}

// Alpha-mask background compositing of a whole split, in place, the images
// split over n_threads threads: images [n, pixels, 4] float32 (alpha < 1 is
// foreground and keeps its colour, any other pixel takes the background's),
// bg [n_bg, pixels, 3], bg_idx [n] (background bg_idx % n_bg).
int composite_backgrounds(float* images, int64_t n, int64_t pixels,
                          const float* bg, int64_t n_bg,
                          const int64_t* bg_idx, int n_threads) {
  if (n_bg <= 0) return 2;
  for (int64_t i = 0; i < n; ++i)
    if (bg_idx[i] < 0) return 2;
  parallel_chunks(n, n_threads, [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      float* img = images + i * pixels * 4;
      const float* b = bg + (bg_idx[i] % n_bg) * pixels * 3;
      for (int64_t p = 0; p < pixels; ++p) {
        if (!(img[p * 4 + 3] < 1.0f)) {
          img[p * 4 + 0] = b[p * 3 + 0];
          img[p * 4 + 1] = b[p * 3 + 1];
          img[p * 4 + 2] = b[p * 3 + 2];
        }
      }
    }
  });
  return 0;
}

}  // extern "C"
