/* C ABI of lgbm_native.so — the implemented subset of the reference's
 * include/LightGBM/c_api.h, signature-compatible so FFI callers can
 * switch by swapping the shared library.
 *
 * Serving entry points (model loading + prediction) are pure C++ with
 * no interpreter in the process. Training entry points lazily embed a
 * Python interpreter (dlopen of libpython at first call; set
 * LGBM_TPU_LIBPYTHON if it is not on the default search path) and
 * drive the PyTorch engine; training calls must come from ONE thread.
 *
 * Every function returns 0 on success and -1 on failure;
 * LGBM_GetLastError() describes the most recent failure.
 */
#ifndef LGBM_TPU_C_API_H_
#define LGBM_TPU_C_API_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* DatasetHandle;
typedef void* BoosterHandle;

/* dtype codes (ref: c_api.h C_API_DTYPE_*) */
#define C_API_DTYPE_FLOAT32 (0)
#define C_API_DTYPE_FLOAT64 (1)
#define C_API_DTYPE_INT32 (2)
#define C_API_DTYPE_INT64 (3)

/* predict_type codes */
#define C_API_PREDICT_NORMAL (0)
#define C_API_PREDICT_RAW_SCORE (1)
#define C_API_PREDICT_LEAF_INDEX (2)
#define C_API_PREDICT_CONTRIB (3)

const char* LGBM_GetLastError(void);

/* ---- serving (interpreter-free) ---------------------------------- */
int LGBM_BoosterCreateFromModelfile(const char* filename,
                                    int* out_num_iterations,
                                    BoosterHandle* out);
int LGBM_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations,
                                    BoosterHandle* out);
int LGBM_BoosterFree(BoosterHandle handle);
int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len);
int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len);
int LGBM_BoosterGetCurrentIteration(BoosterHandle handle, int* out);
int LGBM_BoosterNumModelPerIteration(BoosterHandle handle, int* out);
int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
                              int data_type, int32_t nrow, int32_t ncol,
                              int is_row_major, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result);
int LGBM_BoosterPredictForCSR(BoosterHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result);

/* ---- training (embedded engine; single-threaded) ------------------ */
int LGBM_DatasetCreateFromMat(const void* data, int data_type,
                              int32_t nrow, int32_t ncol,
                              int is_row_major, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);
/* C++-only row-iterator variant (SWIG wrapper contract): get_row_funptr is a
 * std::function<void(int, std::vector<std::pair<int,double>>&)>* producing one
 * sparse row per call (ref: c_api.h:436). */
int LGBM_DatasetCreateFromCSRFunc(void* get_row_funptr, int num_rows,
                                  int64_t num_col, const char* parameters,
                                  const void* reference, void** out);
int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t nindptr,
                              int64_t nelem, int64_t num_col,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);
int LGBM_DatasetCreateFromFile(const char* filename,
                               const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out);
int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name,
                         const void* field_data, int32_t num_element,
                         int data_type);
int LGBM_DatasetGetField(DatasetHandle handle, const char* field_name,
                         int* out_len, const void** out_ptr,
                         int* out_type);
int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                const char** feature_names,
                                int num_feature_names);
int LGBM_DatasetGetFeatureNames(DatasetHandle handle, const int len,
                                int* out_len, const size_t buffer_len,
                                size_t* out_buffer_len, char** out_strs);
int LGBM_DatasetSaveBinary(DatasetHandle handle, const char* filename);
int LGBM_DatasetGetNumData(DatasetHandle handle, int32_t* out);
int LGBM_DatasetGetNumFeature(DatasetHandle handle, int32_t* out);
int LGBM_DatasetFree(DatasetHandle handle);

int LGBM_BoosterCreate(DatasetHandle train_data, const char* parameters,
                       BoosterHandle* out);
int LGBM_BoosterAddValidData(BoosterHandle handle,
                             DatasetHandle valid_data);
int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished);
int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle,
                                    const float* grad, const float* hess,
                                    int* is_finished);
int LGBM_BoosterResetParameter(BoosterHandle handle,
                               const char* parameters);
int LGBM_BoosterGetFeatureNames(BoosterHandle handle, const int len,
                                int* out_len, const size_t buffer_len,
                                size_t* out_buffer_len, char** out_strs);
int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                               int predict_type, int start_iteration,
                               int num_iteration, int64_t* out_len);
int LGBM_BoosterPredictForFile(BoosterHandle handle,
                               const char* data_filename,
                               int data_has_header, int predict_type,
                               int start_iteration, int num_iteration,
                               const char* parameter,
                               const char* result_filename);
int LGBM_BoosterPredictForMatSingleRow(
    BoosterHandle handle, const void* data, int data_type, int ncol,
    int is_row_major, int predict_type, int start_iteration,
    int num_iteration, const char* parameter, int64_t* out_len,
    double* out_result);
int LGBM_BoosterRollbackOneIter(BoosterHandle handle);
int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle,
                                   int* out_models);
int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len);
int LGBM_BoosterGetEvalNames(BoosterHandle handle, const int len,
                             int* out_len, const size_t buffer_len,
                             size_t* out_buffer_len, char** out_strs);
int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx, int* out_len,
                        double* out_results);
int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                              int64_t* out_len);
int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                           int64_t* out_len, double* out_result);
int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double* out_val);
int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double val);
int LGBM_BoosterRefit(BoosterHandle handle, const double* leaf_preds,
                      int32_t nrow, int32_t ncol);
int LGBM_BoosterSaveModel(BoosterHandle handle, int start_iteration,
                          int num_iteration, int feature_importance_type,
                          const char* filename);
int LGBM_BoosterSaveModelToString(BoosterHandle handle,
                                  int start_iteration, int num_iteration,
                                  int feature_importance_type,
                                  int64_t buffer_len, int64_t* out_len,
                                  char* out_str);

/* ---- wave 2 (ref: c_api.h:73-332, :394, :440, :491-686, :731-779,
 * :1095-1145, :1193-1428, :1655-1682) ---- */

typedef void* FastConfigHandle;
typedef void* ByteBufferHandle;

/* dataset creation: CSC, multi-matrix, streaming */
int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t ncol_ptr,
                              int64_t nelem, int64_t num_row,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);
int LGBM_DatasetCreateFromMats(int32_t nmat, const void** data,
                               int data_type, int32_t* nrow,
                               int32_t ncol, int* is_row_major,
                               const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out);
int LGBM_DatasetCreateFromSampledColumn(
    double** sample_data, int** sample_indices, int32_t ncol,
    const int* num_per_col, int32_t num_sample_row,
    int32_t num_local_row, int64_t num_dist_row,
    const char* parameters, DatasetHandle* out);
int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                  int64_t num_total_row,
                                  DatasetHandle* out);
int LGBM_DatasetInitStreaming(DatasetHandle dataset, int32_t has_weights,
                              int32_t has_init_scores,
                              int32_t has_queries, int32_t nclasses,
                              int32_t nthreads, int32_t omp_max_threads);
int LGBM_DatasetPushRows(DatasetHandle dataset, const void* data,
                         int data_type, int32_t nrow, int32_t ncol,
                         int32_t start_row);
int LGBM_DatasetPushRowsWithMetadata(
    DatasetHandle dataset, const void* data, int data_type,
    int32_t nrow, int32_t ncol, int32_t start_row, const float* label,
    const float* weight, const double* init_score, const int32_t* query,
    int32_t tid);
int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int64_t start_row);
int LGBM_DatasetPushRowsByCSRWithMetadata(
    DatasetHandle dataset, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t start_row,
    const float* label, const float* weight, const double* init_score,
    const int32_t* query, int32_t tid);
int LGBM_DatasetSetWaitForManualFinish(DatasetHandle dataset, int wait);
int LGBM_DatasetMarkFinished(DatasetHandle dataset);

/* dataset ops */
int LGBM_DatasetGetSubset(const DatasetHandle handle,
                          const int32_t* used_row_indices,
                          int32_t num_used_row_indices,
                          const char* parameters, DatasetHandle* out);
int LGBM_DatasetAddFeaturesFrom(DatasetHandle target,
                                DatasetHandle source);
int LGBM_DatasetDumpText(DatasetHandle handle, const char* filename);
int LGBM_DatasetGetFeatureNumBin(DatasetHandle handle, int feature_idx,
                                 int* out);
int LGBM_DatasetUpdateParamChecking(const char* old_parameters,
                                    const char* new_parameters);

/* reference-schema serialization */
int LGBM_DatasetSerializeReferenceToBinary(DatasetHandle handle,
                                           ByteBufferHandle* out_buffer,
                                           int32_t* out_len);
int LGBM_DatasetCreateFromSerializedReference(
    const void* ref_buffer, int32_t ref_buffer_size, int64_t num_row,
    int32_t num_classes, const char* parameters, DatasetHandle* out);
int LGBM_ByteBufferGetAt(ByteBufferHandle handle, int32_t index,
                         uint8_t* out_val);
int LGBM_ByteBufferFree(ByteBufferHandle handle);

/* booster introspection */
int LGBM_BoosterDumpModel(BoosterHandle handle, int start_iteration,
                          int num_iteration,
                          int feature_importance_type,
                          int64_t buffer_len, int64_t* out_len,
                          char* out_str);
int LGBM_BoosterGetLoadedParam(BoosterHandle handle, int64_t buffer_len,
                               int64_t* out_len, char* out_str);
int LGBM_BoosterFeatureImportance(BoosterHandle handle,
                                  int num_iteration, int importance_type,
                                  double* out_results);
int LGBM_BoosterMerge(BoosterHandle handle, BoosterHandle other_handle);
int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                  const DatasetHandle train_data);
int LGBM_BoosterShuffleModels(BoosterHandle handle, int start_iter,
                              int end_iter);
int LGBM_BoosterGetLinear(BoosterHandle handle, int* out);
int LGBM_BoosterValidateFeatureNames(BoosterHandle handle,
                                     const char** data_names,
                                     int data_num_features);
int LGBM_BoosterGetLowerBoundValue(BoosterHandle handle,
                                   double* out_results);
int LGBM_BoosterGetUpperBoundValue(BoosterHandle handle,
                                   double* out_results);

/* prediction: CSC, multi-matrix, sparse output, single-row fast */
int LGBM_BoosterPredictForCSC(BoosterHandle handle, const void* col_ptr,
                              int col_ptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result);
int LGBM_BoosterPredictForMats(BoosterHandle handle, const void** data,
                               int data_type, int32_t nrow, int32_t ncol,
                               int predict_type, int start_iteration,
                               int num_iteration, const char* parameter,
                               int64_t* out_len, double* out_result);
int LGBM_BoosterPredictSparseOutput(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col_or_row,
    int predict_type, int start_iteration, int num_iteration,
    const char* parameter, int matrix_type, int64_t* out_len,
    void** out_indptr, int32_t** out_indices, void** out_data);
int LGBM_BoosterFreePredictSparse(void* indptr, int32_t* indices,
                                  void* data, int indptr_type,
                                  int data_type);
int LGBM_BoosterPredictForMatSingleRowFastInit(
    BoosterHandle handle, const int predict_type,
    const int start_iteration, const int num_iteration,
    const int data_type, const int32_t ncol, const char* parameter,
    FastConfigHandle* out_fastConfig);
int LGBM_BoosterPredictForMatSingleRowFast(FastConfigHandle fastConfig,
                                           const void* data,
                                           int64_t* out_len,
                                           double* out_result);
int LGBM_BoosterPredictForCSRSingleRow(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int predict_type,
    int start_iteration, int num_iteration, const char* parameter,
    int64_t* out_len, double* out_result);
int LGBM_BoosterPredictForCSRSingleRowFastInit(
    BoosterHandle handle, const int predict_type,
    const int start_iteration, const int num_iteration,
    const int data_type, const int64_t num_col, const char* parameter,
    FastConfigHandle* out_fastConfig);
int LGBM_BoosterPredictForCSRSingleRowFast(
    FastConfigHandle fastConfig, const void* indptr,
    const int indptr_type, const int32_t* indices, const void* data,
    const int64_t nindptr, const int64_t nelem, int64_t* out_len,
    double* out_result);
int LGBM_FastConfigFree(FastConfigHandle fastConfig);

/* process-level utilities */
int LGBM_SetLastError(const char* msg);
int LGBM_RegisterLogCallback(void (*callback)(const char*));
int LGBM_SetMaxThreads(int num_threads);
int LGBM_GetMaxThreads(int* out);
int LGBM_GetSampleCount(int32_t num_total_row, const char* parameters,
                        int* out);
int LGBM_SampleIndices(int32_t num_total_row, const char* parameters,
                       void* out, int32_t* out_len);
int LGBM_DumpParamAliases(int64_t buffer_len, int64_t* out_len,
                          char* out_str);

/* Arrow C data/stream interface ingestion (ref: c_api.h:461-480,
 * :596-616, :1493-1536; struct ABI per the Apache Arrow spec) */
struct ArrowArray;
struct ArrowSchema;
struct ArrowArrayStream;
int LGBM_DatasetCreateFromArrow(int64_t n_chunks,
                                struct ArrowArray* chunks,
                                struct ArrowSchema* schema,
                                const char* parameters,
                                const DatasetHandle reference,
                                DatasetHandle* out);
int LGBM_DatasetCreateFromArrowStream(struct ArrowArrayStream* stream,
                                      const char* parameters,
                                      const DatasetHandle reference,
                                      DatasetHandle* out);
int LGBM_DatasetSetFieldFromArrow(DatasetHandle handle,
                                  const char* field_name,
                                  int64_t n_chunks,
                                  struct ArrowArray* chunks,
                                  struct ArrowSchema* schema);
int LGBM_DatasetSetFieldFromArrowStream(DatasetHandle handle,
                                        const char* field_name,
                                        struct ArrowArrayStream* stream);
int LGBM_BoosterPredictForArrow(BoosterHandle handle, int64_t n_chunks,
                                struct ArrowArray* chunks,
                                struct ArrowSchema* schema,
                                int predict_type, int start_iteration,
                                int num_iteration, const char* parameter,
                                int64_t* out_len, double* out_result);
int LGBM_BoosterPredictForArrowStream(BoosterHandle handle,
                                      struct ArrowArrayStream* stream,
                                      int predict_type,
                                      int start_iteration,
                                      int num_iteration,
                                      const char* parameter,
                                      int64_t* out_len,
                                      double* out_result);

/* network (ref: c_api.h:1655-1682) */
int LGBM_NetworkInit(const char* machines, int local_listen_port,
                     int listen_time_out, int num_machines);
int LGBM_NetworkFree(void);
int LGBM_NetworkInitWithFunctions(int num_machines, int rank,
                                  void* reduce_scatter_ext_fun,
                                  void* allgather_ext_fun);

#ifdef __cplusplus
}
#endif

#endif /* LGBM_TPU_C_API_H_ */
